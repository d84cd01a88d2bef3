"""The ready-bucket grad-sync overlap (``gradsync/overlap.py``,
``TrainConfig.overlap``, the trainer's ``--overlap``) against the
post-backward path and against the reference's overlap.

- ``segmented_grads`` (three ``torch.autograd.grad`` segments, head ->
  stack -> embed) joins to ``microbatched_grads`` bit for bit for every
  family at smoke size, at one and two microbatches, the tied
  embeddings' two contributions included.
- A yielded gradient piece is freed once its consumer drops it (no
  reference from the generator, none from a reference cycle of
  ``buckets.tree_flatten``).
- The readiness groups partition the params as the reference's do: for
  every arch each leaf's group and each key's offset equal the
  reference's ``leaf_groups``/``key_offsets`` over its own param tree.
- ``overlap`` on equals off bit for bit (the losses, grad norms, params,
  optimizer rows and EF residuals) under ``mrd_zero1``, ``compressed``,
  ``mrd_paper`` and ``mrd_leaf``: on stacked rows at dp 3, and in gloo
  worlds of 3 ranks and of ``(2, 2)`` (``torch_dist_worker.overlap_world``),
  whose device plans wait on a stage's messages only at its finish.
- The port's overlap step is held to the reference's overlap step
  (``compressed`` at dp 3, teacher-forced for 2 steps) with
  ``test_torch_train_families``' compressed tolerances: the reference's
  segmented backward is not bitwise its own post-backward one under
  microbatches (ROADMAP queue 3, fault c), so no comparison across the
  packages is bitwise.
"""

import dataclasses
import gc
import weakref

import jax
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402
from repro.distributed.gradsync import overlap as ref_overlap  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.collectives import buckets  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.distributed.gradsync import common, overlap  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402

from test_torch_train_families import MODES, check_train_steps, train_tcfg  # noqa: E402
from torch_train_ref import one_thread, record_script, run_reference  # noqa: E402,F401

ARCHS = registry.list_archs()
REF_TAG, REF_DP, REF_STEPS = "overlap-compressed/", 3, 2


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_segmented_grads_join_to_microbatched_grads_bit_for_bit(arch, microbatches):
    cfg = registry.get_smoke_config(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticPipeline(cfg, DataConfig(batch=4, seq_len=16, seed=1), "cpu").next_batch()
    grads, loss, metrics = common.microbatched_grads(params, batch, cfg, "full", microbatches)
    emitter = overlap.segmented_grads(params, batch, cfg, "full", microbatches)
    seg_loss, seg_metrics = next(emitter)
    names, joined = [], {}
    for name, piece in emitter:
        names.append(name)
        assert not set(piece) & set(joined)
        joined.update(piece)
    assert names == list(overlap.GROUP_NAMES)
    assert torch.equal(seg_loss, loss)
    for k, v in metrics.items():
        assert torch.equal(seg_metrics[k], v), k
    want, paths = buckets.tree_flatten(convert.reference_tree(grads))
    got, got_paths = buckets.tree_flatten(convert.reference_tree(joined))
    assert got_paths == paths
    for p, a, b in zip(paths, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (arch, microbatches, p)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-32b"])
def test_a_yielded_gradient_dies_with_the_consumers_reference(arch, microbatches):
    """With the cyclic collector off, each gradient piece is freed as soon as
    its consumer drops it: neither the segmented backward nor a flatten of
    the piece keeps a reference, so a step holds no group's gradients past
    their packing (tied and untied embeddings)."""
    cfg = registry.get_smoke_config(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticPipeline(cfg, DataConfig(batch=4, seq_len=16, seed=1), "cpu").next_batch()
    emitter = overlap.segmented_grads(params, batch, cfg, "full", microbatches)
    next(emitter)
    gc.disable()
    try:
        for name, piece in emitter:
            leaves, _ = buckets.tree_flatten(piece)
            alive = [weakref.ref(t) for t in leaves]
            del piece, leaves
            assert not [r for r in alive if r() is not None], (arch, name)
    finally:
        gc.enable()


@pytest.mark.parametrize("arch", ARCHS)
def test_group_partition_covers_params(arch):
    """Every top-level key lands in one readiness group, each leaf's group
    and each key's offset are the reference's."""
    cfg = registry.get_smoke_config(arch)
    shapes = transformer.param_shapes(cfg)
    groups = {overlap.group_of_key(k) for k in shapes}
    assert groups <= set(range(overlap.N_GROUPS)) and 1 in groups
    rshape = jax.eval_shape(lambda k: ref_tf.init_params(cfg, k), jax.random.PRNGKey(0))
    assert overlap.leaf_groups(shapes) == ref_overlap.leaf_groups(rshape)
    assert overlap.key_offsets(shapes) == ref_overlap.key_offsets(rshape)
    for k in shapes:
        assert overlap.group_of_key(k) == ref_overlap.group_of_key(k)
    layout = buckets.build_layout(convert.reference_tree(shapes), bucket_bytes=1 << 14,
                                  dtype=torch.float32)
    bgroups = overlap.bucket_groups(layout, overlap.leaf_groups(shapes))
    assert len(bgroups) == len(layout.buckets) and set(bgroups) <= groups


def _run(mode: str, on: bool, dp: int = 3, steps: int = 2, microbatches: int = 1):
    cfg = registry.get_smoke_config("llama3.2-1b")
    tcfg = dataclasses.replace(train_tcfg(mode, microbatches=microbatches), overlap=on)
    step = step_lib.make_train_step(cfg, tcfg, dp=dp, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticPipeline(cfg, DataConfig(batch=2 * dp, seq_len=16, seed=0), "cpu")
    out = []
    for _ in range(steps):
        state, m = step(state, pipe.next_batch())
        flat = W.flat(convert.train_state_to_reference(state), "")
        out.append(({k: v.clone() for k, v in flat.items()}, m))
    return out


@pytest.mark.parametrize("mode", W.OVERLAP_MODES)
def test_overlap_equals_post_backward_on_stacked_rows(mode):
    off, on = _run(mode, False, microbatches=2), _run(mode, True, microbatches=2)
    for (s0, m0), (s1, m1) in zip(off, on):
        for k in ("loss", "grad_norm", "monitor_value"):
            assert torch.equal(m0[k], m1[k]), (mode, k)
        assert sorted(s0) == sorted(s1)
        for k, v in s0.items():
            assert torch.equal(v, s1[k]), (mode, k)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for shape, names in (((3,), ("data",)), ((2, 2), ("data", "model"))):
        dp = shape[0]
        out[shape] = W.run_world(tmp_path_factory.mktemp("overlap"), "overlap_world", shape,
                                 names, args={"arch": "llama3.2-1b", "steps": 2,
                                              "batch": 2 * dp}, deadline_s=300)
    return out


@pytest.mark.parametrize("shape", [(3,), (2, 2)])
@pytest.mark.parametrize("mode", W.OVERLAP_MODES)
def test_overlap_equals_post_backward_in_a_world(worlds, shape, mode):
    for r, rec in enumerate(worlds[shape]):
        off = {k[len(f"{mode}/off/"):]: v for k, v in rec.items()
               if k.startswith(f"{mode}/off/")}
        on = {k[len(f"{mode}/on/"):]: v for k, v in rec.items() if k.startswith(f"{mode}/on/")}
        assert sorted(off) == sorted(on) and off
        for k, v in off.items():
            assert torch.equal(v, on[k]), (shape, mode, r, k)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    extra = [dict(tag=REF_TAG, arch="llama3.2-1b", mode="compressed", dp=REF_DP,
                  steps=REF_STEPS, tcfg={"overlap": True, "microbatches": 2})]
    script = record_script({}, steps=REF_STEPS, lr=1e-2, modes=MODES, extra=extra)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=REF_DP)


def test_overlap_step_holds_to_the_references(reference_run):
    check_train_steps(reference_run, "llama3.2-1b", "compressed", dp=REF_DP, steps=REF_STEPS,
                      tag=REF_TAG, overlap=True, microbatches=2)
