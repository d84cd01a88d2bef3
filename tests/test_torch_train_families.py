"""The port's train steps against the reference's for the families with
a stack of their own: gemma3's grouped local/global stack, falcon-mamba's
mamba1 stack (the chunked scan) and zamba2's hybrid stack, at their smoke
configs, dp 3, under ``mrd_zero1`` and ``compressed`` for 3 steps.

One subprocess with 3 forced host devices runs the reference's
``make_train_step`` and records the initial state, the batches, and each
step's metrics and state.  The port starts every step from the
reference's own state before it (``train_state_from_reference``;
teacher-forced) and runs the same batch, so each step is held to
``test_torch_train.py``'s tolerances: loss atol 1e-5, grad norm rtol 1e-4
(5e-4 compressed), ``converged`` exact and the published value rtol
1e-6; after the step, under ``compressed`` its int8 rounding-tie rule:
at most 2% of a leaf's param, master and moment elements beyond 1e-4,
none beyond 2 x lr (params, masters) or 1e-2 (moments), and the EF
residuals none beyond 2.5 x the reference's largest residual of the
leaf.  (``test_torch_train.py`` bounds the EF residuals by 1e-2, a
quantization step at llama's gradient sizes; a residual lies within half
a step of zero, so two differ by at most a step, and zamba2's larger
smoke gradients, norms 26-32, have steps up to 3.4e-2: the bound follows
the step.)  Under the exact syncs the params and masters are held at
``test_torch_train.py``'s atol 5e-4, the moments at 1e-5; the one
exception is a coordinate whose gradient in the reference (recovered
from its first moment, ``(mu' - beta1 mu) / (1 - beta1)``) is within
fp32 summation noise of zero, below ``NOISE`` = 1e-7 (1e-6 of the
largest coordinate, 0.03-0.16 here): AdamW's first updates are about
+-lr whatever a coordinate's size, so the sign that noise gives such a
gradient moves it by up to 2 x lr (one element of zamba2's and one of
internvl2's at step 1, gradients 8e-9 and 3e-8; every other element is
within 6.3e-5).  Free-running steps would carry such a coordinate, and
an EF residual of a flipped tie, into every later gradient: by step 3 up
to 11% of the elements differ by more than 1e-4 (zamba2, compressed) and
the loss by up to 5.7e-5 relative, a drift that says nothing about the
step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.collectives import buckets  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.distributed.gradsync.mrd_zero1 import zero1_masters_from_params  # noqa: E402
from repro_torch.models.convert import sync_layout, train_state_from_reference  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402

from torch_train_ref import (  # noqa: E402,F401
    one_thread,
    record_script,
    run_reference,
    torch_batch,
    tree,
)

LR, STEPS, DP = 1e-2, 3, 3
MODES = {"mrd_zero1": "exact", "compressed": "inexact"}
ARCHS = ("gemma3-12b", "falcon-mamba-7b", "zamba2-2.7b")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    script = record_script({a: list(MODES) for a in ARCHS}, steps=STEPS, lr=LR, modes=MODES)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=DP)


NOISE = 1e-7  # a gradient coordinate this close to zero takes its sign from summation order
BUCKET_BYTES = 1 << 15


def _tmap(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def check_exact(state, ref, before, what: str, optimizer: str = "adamw") -> None:
    """The exact syncs' params and masters: within 5e-4 of the reference's
    but for the coordinates whose reference gradient of the step (from its
    first moment; ``before``: its state before the step) is within
    ``NOISE`` of zero.  The ZeRO-1 params are compared in the master rows'
    layout; a ``local_sgd`` replica's params at every replica's noise
    coordinates (an average carries each replica's).  Under Lion the tie is
    its ``sign``'s argument ``beta1 mu + (1 - beta1) g`` within ``NOISE``
    of zero (the gradient from its moment ``beta2 mu + (1 - beta2) g``);
    SGD's update is ``lr`` times the gradient, with no tie to excuse."""
    b1, b2 = OptimizerConfig().beta1, OptimizerConfig().beta2

    def noise(mu, mu0):
        if optimizer == "sgd":
            return torch.zeros_like(mu, dtype=torch.bool)
        if optimizer == "lion":
            g = (mu - b2 * mu0) / (1 - b2)
            return (b1 * mu0 + (1 - b1) * g).abs() <= NOISE
        return ((mu - b1 * mu0) / (1 - b1)).abs() <= NOISE

    if sync_layout(ref) == "zero1":
        dp = ref["opt"]["mu"].shape[0]
        mask = noise(ref["opt"]["mu"], before["opt"]["mu"])
        dpar = _tmap(lambda a, b: (a.float() - b.float()).abs(), state["params"], ref["params"])
        pairs = [("params", zero1_masters_from_params(dpar, dp, bucket_bytes=BUCKET_BYTES), mask),
                 ("master", (state["opt"]["master"] - ref["opt"]["master"]).abs(), mask)]
    else:
        mus, names = buckets.tree_flatten(ref["opt"]["mu"])
        masks = [noise(a, b) for a, b in zip(mus, buckets.tree_flatten(before["opt"]["mu"])[0])]
        local = sync_layout(ref) == "local"
        pairs = []
        for part, ours, theirs in (("params", state["params"], ref["params"]),
                                   ("master", state["opt"]["master"], ref["opt"]["master"])):
            a, an = buckets.tree_flatten(ours)
            b, bn = buckets.tree_flatten(theirs)
            assert an == bn == names, (what, part)
            for name, x, y, m in zip(names, a, b, masks):
                if part == "params" and local:
                    m = m.any(0, keepdim=True).expand_as(m)
                pairs.append((f"{part} {name}", (x.float() - y.float()).abs(), m))
    for name, d, mask in pairs:
        worst = float(d[~mask].max()) if bool((~mask).any()) else 0.0
        assert worst <= 5e-4, (what, name, worst)


def check_state(state, ref, what: str, compressed: bool, before=None,
                optimizer: str = "adamw") -> None:
    """Params and optimizer leaves after one step: at most 2% of the
    elements of a leaf beyond 1e-4 and none beyond 2 x lr (the compressed
    sync's moments: 1e-2; its EF residuals: 2.5 x the reference's
    largest); the other syncs' moments within 1e-5, and their params and
    masters as :func:`check_exact` holds them (``before``: the
    reference's state before the step)."""
    for part in ("params", "opt"):
        names, ours = buckets.tree_flatten(state[part])[1], buckets.tree_flatten(state[part])[0]
        rnames, theirs = buckets.tree_flatten(ref[part])[1], buckets.tree_flatten(ref[part])[0]
        assert names == rnames, (what, part)
        for name, a, b in zip(names, ours, theirs):
            assert a.shape == b.shape, (what, name)
            row = part == "opt" and name[0] in ("mu", "nu", "ef")
            if row and not compressed:
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=f"{what} {name}")
                continue
            d = (a - b).abs()
            bound = 2 * LR
            if row:
                bound = 2.5 * float(b.abs().max()) if name[0] == "ef" else 1e-2
            assert float(d.max()) <= bound, (what, name, float(d.max()))
            assert float((d > 1e-4).float().mean()) <= 0.02, (what, name,
                                                              float((d > 1e-4).float().mean()))
    if not compressed:
        check_exact(state, ref, before, what, optimizer)


def train_tcfg(mode, optimizer=None, **tcfg_kw) -> step_lib.TrainConfig:
    """The recording's TrainConfig of ``mode`` (``optimizer``: its
    OptimizerConfig fields; ``tcfg_kw``: TrainConfig fields)."""
    kw = dict(microbatches=1, remat="none")
    kw.update(tcfg_kw)
    return step_lib.TrainConfig(
        grad_sync=mode, monitor=mode != "local_sgd",
        monitor_mode=MODES.get(mode, "inexact"), monitor_threshold=6.0, bucket_bytes=BUCKET_BYTES,
        optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0, grad_clip=1.0,
                                  **(optimizer or {})), **kw)


def check_metrics(m, rm, mode: str, what) -> None:
    """A step's metrics ``m`` against the reference's ``rm``."""
    assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5, (what, float(m["loss"]))
    rtol = 5e-4 if mode == "compressed" else 1e-4
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=rtol)
    assert bool(m["converged"]) == bool(rm["converged"]), what
    np.testing.assert_allclose(float(m["monitor_value"]), float(rm["monitor_value"]), rtol=1e-6)


def check_monitor(state, after) -> None:
    """The monitor's counters and flags after a step against the
    reference's."""
    if "monitor" in state:
        assert state["monitor"]["nb"]["stage"] == after["monitor"]["nb"]["stage"]
        assert state["monitor"]["nb"]["cycles"] == after["monitor"]["nb"]["cycles"]
        torch.testing.assert_close(state["monitor"]["done"], after["monitor"]["done"])


def check_train_steps(z, arch, mode, dp=DP, steps=STEPS, tag=None, optimizer=None, **tcfg_kw):
    """Run every step of the port from the reference's state before it on
    the reference's batch, and hold its metrics and the state after it to
    the reference's.  Returns the port's state after the last step.
    ``tag`` names a recording's extra run, ``optimizer`` its
    OptimizerConfig fields."""
    cfg = registry.get_smoke_config(arch)
    tag = tag or f"{arch}/{mode}/{dp}/"
    tcfg = train_tcfg(mode, optimizer, **tcfg_kw)
    step = step_lib.make_train_step(cfg, tcfg, dp=dp, device="cpu")
    for i in range(steps):
        before = tree(z, tag + ("init/" if i == 0 else f"state{i}/"))
        state, m = step(train_state_from_reference(before, cfg, "cpu"),
                        torch_batch(tree(z, f"{tag}batch{i}/")))
        check_metrics(m, tree(z, f"{tag}metrics{i}/"), mode, i)
        after = train_state_from_reference(tree(z, f"{tag}state{i + 1}/"), cfg, "cpu")
        assert state["step"] == after["step"] == i + 1
        check_state(state, after, f"step {i + 1}", mode == "compressed",
                    before=train_state_from_reference(before, cfg, "cpu"),
                    optimizer=tcfg.optimizer.name)
        check_monitor(state, after)
    return state


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(reference_run, arch, mode):
    check_train_steps(reference_run, arch, mode)
