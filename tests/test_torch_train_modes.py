"""The ``mrd_leaf`` and ``local_sgd`` grad-sync modes against the
reference's, on the smoke ``llama3.2-1b`` at dp 3 and 5 (the paper's
non-power-of-two cases), 4 steps with ``local_sync_every`` 2, so that
``local_sgd`` averages its replicas twice; and ``local_sgd``'s bounded
staleness (the reference's ``tests/test_local_sgd.py``): the replicas
part between averages and are equal bit for bit after each.  And every
registered arch builds and runs a step under every mode at remat
``none``, ``full`` and ``dots``.

The recording, the teacher-forced steps and the tolerances are
``test_torch_train_families.py``'s (``mrd_leaf``'s replicated AdamW has
its first-step sign flips; each ``local_sgd`` replica has its own), and
the optimizer trees are compared leaf by leaf.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.collectives import buckets  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402

from test_torch_train_families import LR, check_train_steps  # noqa: E402
from torch_train_ref import one_thread, record_script, run_reference  # noqa: E402,F401

MODES = ("mrd_leaf", "local_sgd")
DPS = (3, 5)
STEPS, EVERY = 4, 2


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    script = record_script({"llama3.2-1b": list(MODES)}, dps=DPS, steps=STEPS, lr=LR,
                           local_sync_every=EVERY)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=max(DPS))


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_reference(reference_run, mode, dp):
    state = check_train_steps(reference_run, "llama3.2-1b", mode, dp=dp, steps=STEPS,
                              local_sync_every=EVERY)
    if mode == "local_sgd":  # step 4 averaged the replicas
        for leaf in buckets.tree_flatten(state["params"])[0]:
            assert all(torch.equal(leaf[0], leaf[r]) for r in range(dp))


def test_local_sgd_replicas_part_between_averages_and_meet_at_them():
    cfg = registry.get_smoke_config("llama3.2-1b")
    tcfg = step_lib.TrainConfig(remat="none", grad_sync="local_sgd", monitor=False,
                                local_sync_every=3, bucket_bytes=1 << 12,
                                optimizer=OptimizerConfig(lr=5e-3, schedule="const",
                                                          warmup_steps=0))
    step = step_lib.make_train_step(cfg, tcfg, dp=4, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticPipeline(cfg, DataConfig(batch=8, seq_len=16, seed=0), "cpu")
    for i in range(6):
        state, m = step(state, pipe.next_batch())
        w = state["params"]["embed"]
        spread = float((w - w[0]).abs().max())
        if (i + 1) % 3 == 0:
            assert spread == 0.0, (i, spread)
            for leaf in buckets.tree_flatten(state["opt"]["master"])[0]:  # not averaged
                assert not torch.equal(leaf[0], leaf[1])
        else:
            assert spread > 0, i
        assert not bool(m["converged"]) and float(m["monitor_value"]) == 0.0


@pytest.mark.parametrize("mode", ["mrd_paper", "mrd_zero1", "compressed", "mrd_leaf",
                                  "local_sgd"])
def test_every_arch_trains_under_every_mode(mode):
    for arch in registry.list_archs():
        cfg = registry.get_smoke_config(arch)
        for remat in ("none", "full", "dots"):
            tcfg = step_lib.TrainConfig(remat=remat, grad_sync=mode, monitor=True,
                                        monitor_threshold=6.0, local_sync_every=1,
                                        bucket_bytes=1 << 14)
            step = step_lib.make_train_step(cfg, tcfg, dp=3, device="cpu")
            state = step.init_state(torch.Generator().manual_seed(1))
            batch = SyntheticPipeline(cfg, DataConfig(batch=3, seq_len=8), "cpu").next_batch()
            state, m = step(state, batch)
            assert state["step"] == 1
            assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), (
                arch, mode, remat)
