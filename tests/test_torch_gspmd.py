"""The port's ``gspmd`` train step on stacked rows (one process, no mesh)
against the reference's ``gspmd`` at a mesh of one device, for every
family, teacher-forced for 2 steps.

One subprocess runs the reference's ``make_train_step`` (the
``tests/torch_train_ref.py`` recorder, its extra runs) and records the
initial state, the batches, and each step's metrics and state.  The port
starts every step from the reference's state before it and runs the same
batch; each step is held to ``test_torch_train_families.py``'s
tolerances for the exact syncs: loss atol 1e-5, grad norm rtol 1e-4,
``converged`` exact and the published value rtol 1e-6; params and
masters within 5e-4 but for the coordinates whose reference gradient is
within summation noise of zero (``NOISE``), moments within 1e-5, the
monitor's stage, cycles and ``done`` exact.  The moe family's capacity
drops are integer decisions inside the step: a drop that differed would
move a whole token's expert output, far beyond these bounds.

Also: the CLI's default ``--grad-sync`` is ``gspmd`` and it takes
``--tp``; ``--tp`` > 1 with an MRD mode, or without a world, exits.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

from test_torch_train_families import check_train_steps  # noqa: E402
from torch_train_ref import one_thread, record_script, run_reference  # noqa: E402,F401

LR, STEPS = 1e-2, 2
ARCHS = registry.list_archs()


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    extra = [dict(tag=f"{a}/gspmd/1/", arch=a, mode="gspmd", dp=1, steps=STEPS) for a in ARCHS]
    script = record_script({}, steps=STEPS, lr=LR, extra=extra)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_gspmd_steps_match_reference(reference_run, arch):
    check_train_steps(reference_run, arch, "gspmd", dp=1, steps=STEPS)


def test_the_cli_defaults_to_gspmd_and_takes_tp():
    ap = train_cli.build_parser()
    args = ap.parse_args(["--arch", "llama3.2-1b"])
    assert (args.grad_sync, args.tp) == ("gspmd", 1)
    assert ap.parse_args(["--arch", "llama3.2-1b", "--tp", "4"]).tp == 4
    # every mode takes --tp (the MRD modes too); outside a world it exits
    for mode in ("mrd_zero1", "gspmd"):
        with pytest.raises(SystemExit, match="needs a world"):
            train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--tp", "2", "--grad-sync",
                            mode, "--device", "cpu"])


def test_the_cli_trains_gspmd_on_stacked_rows():
    rec = train_cli.main(["--arch", "zamba2-2.7b", "--smoke", "--steps", "2", "--batch", "4",
                          "--seq", "16", "--dp", "2", "--device", "cpu", "--monitor-threshold",
                          "100", "--remat", "dots"])
    assert rec["converged_at"] == 1 and rec["mrd_combine_launches"] == 0
    assert rec["losses"][0] > 0
