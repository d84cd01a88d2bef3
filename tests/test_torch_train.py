"""The port's training path against the reference's, on the smoke
``llama3.2-1b`` in fp32.

One subprocess with 3 forced host devices runs the reference's own
``make_train_step`` at dp 3 for ``mrd_paper``, ``mrd_zero1`` and
``compressed`` (3 steps each, so the ConvergenceMonitor completes one MRD
cycle and certifies) and writes the initial state, the batches, the
metrics and the final state to an ``.npz``.  The port starts from
:func:`train_state_from_reference` and runs the same batches.

Tolerances (the two sides sum in different orders in fp32):

- loss: atol 1e-5; grad norm: rtol 1e-4 (5e-4 for ``compressed``);
  the monitor's ``converged`` flags: exact, its published value: rtol 1e-6.
- params, master rows: atol 5e-4 (AdamW's first steps divide by
  sqrt(nu): a gradient coordinate near zero turns summation noise into a
  visible relative change of its update); moments atol 1e-5.
- ``compressed``: an fp32 gradient that sits on an int8 rounding boundary
  rounds one way in each framework, moving that coordinate by one
  quantization step.  So at most 2% of the param and optimizer elements
  may differ by more than 1e-4 (up to 0.4% is seen), and none by more than
  2 * lr per step for the params and the masters, or 1e-2 for the EF
  residuals (a quantization step at these gradient sizes).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.collectives import buckets, plans  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_reference,
    reference_tree,
    train_state_from_reference,
)
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402

LR, STEPS, DP = 1e-2, 3, 3
MODES = {"mrd_paper": "inexact", "mrd_zero1": "exact", "compressed": "inexact"}

_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro import compat
    from repro.configs import registry
    from repro.data.pipeline import DataConfig, SyntheticPipeline
    from repro.distributed import step as step_lib
    from repro.optim.optimizer import OptimizerConfig

    cfg = registry.get_smoke_config("llama3.2-1b")
    out = {}

    def save(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[prefix + key] = np.asarray(jax.device_get(leaf))

    mesh = compat.make_mesh((3,), ("data",), devices=jax.devices()[:3],
                            axis_types=compat.default_axis_types(1))
    for mode, mon in MODES.items():
        tcfg = step_lib.TrainConfig(
            microbatches=1, remat="none", grad_sync=mode, monitor=True, monitor_mode=mon,
            monitor_threshold=6.0, bucket_bytes=1 << 15,
            optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0, grad_clip=1.0))
        train_step, init_state, state_specs, _ = step_lib.make_train_step(cfg, mesh, tcfg)
        with mesh:
            state = init_state(jax.random.PRNGKey(0))
            state = jax.device_put(state, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                       state_specs(state)))
            save(mode + "/init/", state)
            pipe = SyntheticPipeline(cfg, DataConfig(batch=6, seq_len=16, seed=0), mesh)
            jstep = jax.jit(train_step)
            for i in range(STEPS):
                batch = pipe.next_batch()
                save(f"{mode}/batch{i}/", batch)
                state, metrics = jstep(state, batch)
                save(f"{mode}/metrics{i}/", metrics)
            save(mode + "/final/", state)
    np.savez(sys.argv[1], **out)
    print("REF-TRAIN-DONE")
    """
)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_train") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    script = f"MODES = {MODES!r}\nLR = {LR}\nSTEPS = {STEPS}\n" + _SCRIPT
    proc = subprocess.run([sys.executable, "-c", script, str(path)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-5000:]}"
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _tree(z, prefix):
    out: dict = {}
    for k, v in z.items():
        if k.startswith(prefix):
            parts = k[len(prefix):].split("/")
            node = out
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return out


def _tcfg(mode, **kw):
    return step_lib.TrainConfig(
        microbatches=1, remat="none", grad_sync=mode, monitor=True, monitor_mode=MODES[mode],
        monitor_threshold=6.0, bucket_bytes=1 << 15,
        optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0, grad_clip=1.0), **kw)


def _close_but_for_rounding_ties(ours, ref, max_err):
    """All but 2% of the elements within 1e-4, none beyond ``max_err``."""
    d = (ours - ref).abs()
    assert float((d > 1e-4).float().mean()) <= 0.02, float((d > 1e-4).float().mean())
    assert float(d.max()) <= max_err, float(d.max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_step_matches_reference(reference_run, mode):
    cfg = registry.get_smoke_config("llama3.2-1b")
    step = step_lib.make_train_step(cfg, _tcfg(mode), dp=DP, device="cpu")
    state = train_state_from_reference(_tree(reference_run, mode + "/init/"), cfg, "cpu")
    for i in range(STEPS):
        batch = _tree(reference_run, f"{mode}/batch{i}/")
        state, m = step(state, {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
        rm = _tree(reference_run, f"{mode}/metrics{i}/")
        assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5
        rtol = 5e-4 if mode == "compressed" else 1e-4
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=rtol)
        assert bool(m["converged"]) == bool(rm["converged"]), i
        np.testing.assert_allclose(float(m["monitor_value"]), float(rm["monitor_value"]),
                                   rtol=1e-6)
    assert bool(m["converged"]), "the monitor should certify after one cycle (3 steps at dp 3)"
    fin = train_state_from_reference(_tree(reference_run, mode + "/final/"), cfg, "cpu")
    assert state["step"] == fin["step"] == STEPS
    ours = buckets.tree_flatten(state["params"])[0]
    ref = buckets.tree_flatten(fin["params"])[0]
    for name, (a, b) in zip(buckets.tree_flatten(state["params"])[1], zip(ours, ref)):
        if mode == "compressed":
            _close_but_for_rounding_ties(a, b, 2 * LR * STEPS)
        else:
            torch.testing.assert_close(a, b, atol=5e-4, rtol=0, msg=str(name))
    assert set(state["opt"]) == set(fin["opt"]) == (
        {"master", "mu", "nu", "ef"} if mode == "compressed" else {"master", "mu", "nu"})
    for k in state["opt"]:
        a, b = state["opt"][k], fin["opt"][k]
        assert a.shape == b.shape, k
        if mode == "compressed":
            _close_but_for_rounding_ties(a, b, 2 * LR * STEPS if k == "master" else 1e-2)
        else:
            torch.testing.assert_close(a, b, atol=5e-4 if k == "master" else 1e-5, rtol=0)
    # the monitor's staged reduction is at the same stage, with the same latch
    assert state["monitor"]["nb"]["stage"] == fin["monitor"]["nb"]["stage"]
    assert state["monitor"]["nb"]["cycles"] == fin["monitor"]["nb"]["cycles"]
    torch.testing.assert_close(state["monitor"]["done"], fin["monitor"]["done"])


@pytest.mark.parametrize("mode", ["mrd_zero1", "compressed"])
def test_every_rank_gathers_the_same_params(reference_run, mode):
    """The all-gather's copy stages move raw bytes, so all rows of the
    gathered buckets are equal and the step may keep one param copy."""
    cfg = registry.get_smoke_config("llama3.2-1b")
    step = step_lib.make_train_step(cfg, _tcfg(mode), dp=DP, device="cpu")
    state = train_state_from_reference(_tree(reference_run, mode + "/init/"), cfg, "cpu")
    batch = _tree(reference_run, mode + "/batch0/")
    state, _ = step(state, {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
    layout, _ = step_lib.zero1_layout(state["params"], DP, bucket_bytes=1 << 15)
    seg = [n // 2 for n in layout.bucket_lengths]  # p0 = 2 at dp 3
    master = state["opt"]["master"].to(torch.float32)
    out = plans.allgather_plan(p=DP).run_buffers(list(torch.split(master, seg, dim=1)))
    for b in out:
        assert torch.equal(b[0], b[1]) and torch.equal(b[0], b[2])
    ours = buckets.pack(reference_tree(state["params"]), layout)
    for b, o in zip(out, ours):
        assert torch.equal(b[0], o)


def test_forward_train_matches_reference():
    """Loss and per-sequence losses at smoke width in fp32 within 1e-5
    (summation order); ``remat='full'`` gives the same loss."""
    rcfg = ref_registry.get_smoke_config("llama3.2-1b")
    cfg = registry.get_smoke_config("llama3.2-1b")
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(3))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(3, 17))
    labels = toks[:, 1:].copy()
    labels[1, :4] = -1  # masked positions
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(labels)}
    rloss, rmet = ref_tf.forward_train(rparams, rbatch, rcfg)
    for remat in ("none", "full"):
        loss, met = transformer.forward_train(params, batch, cfg, remat)
        np.testing.assert_allclose(float(loss), float(rloss), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(met["per_example"].numpy(),
                                   np.asarray(rmet["per_example"]), atol=1e-5, rtol=1e-5)
        assert float(met["ntok"]) == float(rmet["ntok"])


def test_microbatches_average_to_the_full_batch_gradient():
    """Two microbatches of 1 sequence each give the 2-sequence gradient
    (fp32, atol 1e-6: the per-token mean weighs both halves equally)."""
    cfg = registry.get_smoke_config("llama3.2-1b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    g1, l1, _ = step_lib.microbatched_grads(params, batch, cfg, "none", 1)
    g2, l2, _ = step_lib.microbatched_grads(params, batch, cfg, "full", 2)
    np.testing.assert_allclose(float(l1), float(l2), atol=1e-6)
    for a, b in zip(buckets.tree_flatten(g1)[0], buckets.tree_flatten(g2)[0]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["mrd_paper", "mrd_zero1", "compressed"])
def test_cli_trains_on_cpu(mode, capsys):
    rec = train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "3", "--batch", "6",
                      "--seq", "16", "--dp", "3", "--grad-sync", mode, "--device", "cpu"])
    assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"]))
    assert all(np.isfinite(rec["grad_norms"])) and rec["tokens_per_s"] > 0
    out = capsys.readouterr().out
    assert "tokens/s" in out and "ms/step" in out and f"x {mode}" in out


@pytest.mark.parametrize("mode", ["inexact", "exact", "interval"])
def test_cli_monitor_certifies_and_stops(mode, capsys):
    """A lenient threshold: the first completed cycle certifies (3 steps at
    dp 3).  ``interval`` latches the max of each rank's last 8 metrics at
    the cycle starts (steps 0, 3, 6, 9): the window holds no initial
    sentinel from step 8 on, so the cycle latched at step 9 certifies when
    it completes, at step 12."""
    rec = train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "12", "--batch", "6",
                      "--seq", "8", "--dp", "3", "--grad-sync", "compressed", "--device", "cpu",
                      "--monitor-threshold", "100", "--monitor-mode", mode])
    expect = {"inexact": 3, "exact": 3, "interval": 12}[mode]
    assert rec["converged_at"] == expect and len(rec["losses"]) == expect
    assert "certified" in capsys.readouterr().out
