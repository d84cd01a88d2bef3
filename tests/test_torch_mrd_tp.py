"""The MRD grad-sync modes at ``tp`` > 1: gloo worlds over a ``("data",
"model")`` mesh, one process a coordinate, against the reference's modes
at the same mesh on forced host devices.

One subprocess records the reference at every case of
``torch_dist_worker.MRD_TP_CASES`` (the ``tests/torch_train_ref.py``
recorder's extra runs, 6 forced devices): llama3.2-1b under
``mrd_zero1``, ``compressed``, ``mrd_paper``, ``mrd_leaf`` and
``local_sgd`` at ``(2, 2)`` and at ``(3, 2)`` (the paper's
non-power-of-two case: data rank 2 folds onto rank 0 and owns no
segment), mixtral-8x7b (experts replicated, d_ff over TP) under
``mrd_zero1`` and ``mrd_leaf``, falcon-mamba-7b under ``compressed``.
One world a mesh runs its cases (``mrd_tp_forced``), each step
teacher-forced: every coordinate takes its part of the reference's state
before the step (``rank_state``: its blocks of the params, its rows of
the optimizer over its local layout, mapped from the reference's rows
over the flat layout of the whole params by ``mrd_zero1.global_leaves``
and packed into the coordinate's local layout) and its ``"data"`` shard of the batch, and the
reference's state after the step is mapped the same way.

- The exact modes sum every element over the same schedule whatever its
  place in a bucket, so they are held with ``test_torch_train_families``'
  exact-sync tolerances: loss atol 1e-5, grad norm rtol 1e-4 (the norm
  counts each global element once: a leaf replicated over ``"model"``
  on model rank 0 only), masters and params within 5e-4 but for the
  coordinates whose gradient is within 1e-7 of zero (up to 2 x lr), the
  moments within 1e-5.
- ``compressed`` cannot match the reference to fp32 (its int8 blocks lie
  on each coordinate's local layout, the reference's on the flat layout
  of the whole params), so it is held three ways: the loss and monitor
  as above (grad norm rtol 5e-4); at step 1 (the same init as the
  reference's ``mrd_zero1`` run) the decoded mean gradient, recovered
  from the first moment, within the int8 bound of the reference's exact
  gradient: half a quantum of the block's scale for each rank's own EF
  round trip and for each reducing stage, a reducing stage's block scale
  at most its largest sum of the column's absolute gradients over 127;
  and the EF invariant bit for bit on every rank:
  ``dequant(quant(grad + old residual)) + new residual == grad + old
  residual``.  Params and masters move at most 2 x lr from the
  reference's (AdamW's first steps).
- After 3 free-running ``compressed`` steps every leaf replicated over
  ``"model"`` and its EF residual are bit-equal on the model ranks of a
  data rank (their buckets hold no sharded leaf, so every model column
  quantizes them alike).
- A ``(2, 2)`` ``compressed`` world saved after step 1 and resumed gives
  the uninterrupted steps bit for bit; a resume at another ``tp`` is
  refused.
- ``mrd_leaf`` keeps mixtral's fp32 router leaf fp32; the reference's
  tree update rounds it to bf16 (ROADMAP queue 3, "Divergences kept on
  purpose").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.models import convert  # noqa: E402

from test_torch_train_families import LR, MODES, train_tcfg  # noqa: E402
from torch_train_ref import (  # noqa: E402,F401
    one_thread,
    record_script,
    run_reference,
    torch_batch,
    tree,
)

STEPS = 2
CASES = W.MRD_TP_CASES
MESHES = sorted({m for _, _, m, _ in CASES.values()})
FREE_TAG, FREE_STEPS = "llama-compressed-free/", 3
CKPT_ARCH, CKPT_STEPS = "llama3.2-1b", 3


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    extra = [dict(tag=t, arch=a, mode=mode, dp=m[0], tp=m[1], steps=STEPS, tcfg=kw)
             for t, (a, mode, m, kw) in CASES.items()]
    script = record_script({}, steps=STEPS, lr=LR, modes=MODES, extra=extra)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=6)


def forced_runs(z, mesh):
    runs = {}
    for tag, (arch, mode, m, kw) in CASES.items():
        if m != mesh:
            continue
        cfg = registry.get_smoke_config(arch)

        def state(prefix):
            return convert.train_state_from_reference(tree(z, prefix), cfg, "cpu")

        steps = [(state(tag + ("init/" if i == 0 else f"state{i}/")),
                  state(f"{tag}state{i + 1}/"), torch_batch(tree(z, f"{tag}batch{i}/")))
                 for i in range(STEPS)]
        runs[tag] = (arch, train_tcfg(mode, **kw), steps)
    return runs


def batches(n: int, dp: int) -> list:
    cfg = registry.get_smoke_config("llama3.2-1b")
    pipe = SyntheticPipeline(cfg, DataConfig(batch=2 * dp, seq_len=16, seed=0), "cpu")
    return [pipe.next_batch() for _ in range(n)]


@pytest.fixture(scope="module")
def worlds(reference_run, tmp_path_factory):
    out = {}
    for mesh in MESHES:
        root = tmp_path_factory.mktemp(f"mrd_tp_{mesh[0]}x{mesh[1]}")
        args = {"runs": forced_runs(reference_run, mesh)}
        if mesh == (2, 2):
            args["free"] = {FREE_TAG: ("llama3.2-1b", train_tcfg("compressed"),
                                       batches(FREE_STEPS, 2))}
            args["ckpt"] = {"arch": CKPT_ARCH, "tcfg": train_tcfg("compressed"),
                            "directory": str(root / "ckpt"), "batches": batches(CKPT_STEPS, 2)}
        out[mesh] = W.run_world(root / "world", "mrd_tp_forced", mesh, ("data", "model"),
                                args=args, deadline_s=400)
    return out


@pytest.mark.parametrize("tag", sorted(CASES))
def test_world_steps_match_reference(reference_run, worlds, tag):
    z = reference_run
    arch, mode, mesh, kw = CASES[tag]
    assert W.mrd_tcfg(mode, **kw) == train_tcfg(mode, **kw)  # the recording's
    exact = W.MRD_EXACT_OF.get(tag)
    W.check_mrd_case(worlds[mesh], mesh, tag, mode, registry.get_smoke_config(arch),
                     lambda i: tree(z, f"{tag}metrics{i}/"),
                     float(z[f"{exact}metrics0/grad_norm"]) if exact else None, STEPS)


def test_the_grad_norm_counts_each_global_element_once(reference_run, worlds):
    """Every rank reports the reference's global grad norm (each element
    of a leaf replicated over ``"model"`` counted once), and the smoke
    llama has leaves of both kinds, so the count is exercised."""
    z = reference_run
    for tag, (arch, mode, mesh, _) in CASES.items():
        want = float(z[f"{tag}metrics0/grad_norm"])
        for r, _, _ in W.ranks_of(mesh):
            got = float(worlds[mesh][r][f"{tag}step1/metrics/grad_norm"])
            np.testing.assert_allclose(got, want, rtol=5e-4 if mode == "compressed" else 1e-4)
    rep = W.replicated(registry.get_smoke_config("llama3.2-1b"), (2, 2))
    assert any(rep) and not all(rep)


def test_replicated_leaves_stay_equal_and_a_checkpoint_resumes(worlds):
    W.check_mrd_free_and_ckpt(worlds[(2, 2)], FREE_TAG, CKPT_STEPS)


def test_mrd_leaf_keeps_the_fp32_router_the_reference_rounds_it():
    """mixtral's router is an fp32 leaf of bf16 params (the smoke config at
    the full config's bf16 param type): one ``mrd_leaf`` step of the port
    gives it back in fp32, the reference's tree update
    (``optimizer.apply_update``'s ``astype(param_dtype)``) in bf16; both
    packages' ZeRO-1 modes keep it fp32."""
    import dataclasses

    import jax
    from repro import compat
    from repro.configs import registry as ref_registry
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.data.pipeline import SyntheticPipeline as RefPipeline
    from repro.distributed import step as ref_step
    from repro.optim.optimizer import OptimizerConfig as RefOptimizerConfig
    from repro_torch.distributed import step as step_lib

    cfg = dataclasses.replace(registry.get_smoke_config("mixtral-8x7b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    step = step_lib.make_train_step(cfg, train_tcfg("mrd_leaf"), dp=1, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticPipeline(cfg, DataConfig(batch=2, seq_len=16, seed=0), "cpu")
    new, _ = step(state, pipe.next_batch())
    router = new["params"]["layers"]["router"]
    assert state["params"]["layers"]["router"].dtype == router.dtype == torch.float32
    assert new["params"]["layers"]["wq"].dtype == torch.bfloat16

    rcfg = dataclasses.replace(ref_registry.get_smoke_config("mixtral-8x7b"),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))
    tcfg = ref_step.TrainConfig(grad_sync="mrd_leaf", monitor=False, remat="none",
                                optimizer=RefOptimizerConfig(lr=LR, schedule="const",
                                                             warmup_steps=0))
    train_step, init_state, _, _ = ref_step.make_train_step(rcfg, mesh, tcfg)
    with mesh:
        rstate = init_state(jax.random.PRNGKey(0))
        batch = RefPipeline(rcfg, RefDataConfig(batch=2, seq_len=16, seed=0), mesh).next_batch()
        rnew, _ = jax.jit(train_step)(rstate, batch)
    assert str(rstate["params"]["layers"]["moe"]["router"].dtype) == "float32"
    assert str(rnew["params"]["layers"]["moe"]["router"].dtype) == "bfloat16"
