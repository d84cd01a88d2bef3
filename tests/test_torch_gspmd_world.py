"""The port's ``gspmd`` trainer as gloo worlds, one process a rank over a
``("data",)`` or ``("data", "model")`` DeviceMesh, against the
reference's ``gspmd`` at the same mesh on forced host devices.

One subprocess runs the reference at every mesh of :data:`CASES` (the
``tests/torch_train_ref.py`` recorder's extra runs, 4 forced devices);
one world a mesh shape, ``(2, 1)``, ``(1, 2)``, ``(2, 2)`` and ``(1,
4)``, runs that shape's cases (``tests/torch_dist_worker.py``'s
``gspmd_forced``), each step teacher-forced from the reference's state
before it: every rank takes its blocks of that state and its ``"data"``
shard of the batch, and rank 0 gathers the state after the step to
global leaves.  Each step is held to the reference's with
``test_torch_gspmd.py``'s tolerances (``test_torch_train_families``'s
exact-sync rules); the loss and grad norm every rank reports are the
same.  The cases cover every family and the issues each layout raises:

- llama at ``tp`` 4 (``kv_repeat_factor`` 2: its 2 K/V heads repeated so
  the 4 query heads shard), minicpm at ``tp`` 4 (6 heads: replicated);
- qwen2.5 at ``tp`` 2 (5 heads: unsharded, TP in the flattened QKV and
  the MLP) with its qkv biases;
- mixtral at ``dp`` 2 (its 4 experts over ``"data"``: the token
  all-to-all), its capacity drops inside the step;
- falcon-mamba and zamba2 at ``tp`` 2 (mamba1's in_proj split at d_inner,
  the row-parallel x_proj/out_proj, mamba2's gated norm over sharded
  channels);
- gemma3, hubert and llama at ``(2, 2)``, llama with remat ``full`` and
  two microbatches, gemma3 and internvl2 with remat ``dots``; the monitor
  runs in every case.

The ``(2, 2)`` world also checkpoints (``gspmd_checkpoint``): a run
saved after step 1 and resumed gives the uninterrupted run's steps bit
for bit, and the saved leaves are the global ones, which one process
restores.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.models import convert  # noqa: E402

from test_torch_train_families import (  # noqa: E402
    check_metrics,
    check_monitor,
    check_state,
    train_tcfg,
)
from torch_train_ref import (  # noqa: E402,F401
    one_thread,
    record_script,
    run_reference,
    torch_batch,
    tree,
)

LR, STEPS = W.GSPMD_LR, 2
CASES = W.GSPMD_CASES
MESHES = sorted({m for _, m, _, _ in CASES.values()})
CKPT_MESH, CKPT_ARCH, CKPT_STEPS = (2, 2), "llama3.2-1b", 3
mesh_shape = W.mesh_shape


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    extra = [dict(tag=t, arch=a, mode="gspmd", dp=m[0], tp=m[1], steps=STEPS, tcfg=kw,
                  batch=b) for t, (a, m, kw, b) in CASES.items()]
    script = record_script({}, steps=STEPS, lr=LR, extra=extra)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=4)


def forced_runs(z, mesh):
    """This mesh's cases as ``gspmd_forced`` takes them: each step from the
    reference's state before it (the port's stacked layout) on its batch."""
    runs = {}
    for tag, (arch, m, kw, _) in CASES.items():
        if m != mesh:
            continue
        cfg = registry.get_smoke_config(arch)
        steps = [(convert.train_state_from_reference(
                     tree(z, tag + ("init/" if i == 0 else f"state{i}/")), cfg, "cpu"),
                  torch_batch(tree(z, f"{tag}batch{i}/"))) for i in range(STEPS)]
        runs[tag] = (arch, train_tcfg("gspmd", **kw), steps)
    return runs


def checkpoint_args(root):
    cfg = registry.get_smoke_config(CKPT_ARCH)
    pipe = SyntheticPipeline(cfg, DataConfig(batch=4, seq_len=16, seed=0), "cpu")
    return {"arch": CKPT_ARCH, "tcfg": train_tcfg("gspmd"), "directory": str(root / "ckpt"),
            "batches": [pipe.next_batch() for _ in range(CKPT_STEPS)]}


@pytest.fixture(scope="module")
def worlds(reference_run, tmp_path_factory):
    out = {}
    for mesh in MESHES:
        root = tmp_path_factory.mktemp(f"gspmd_{mesh[0]}x{mesh[1]}")
        args = {"runs": forced_runs(reference_run, mesh)}
        if mesh == CKPT_MESH:
            args["ckpt"] = checkpoint_args(root)
        out[mesh] = (W.run_world(root / "world", "gspmd_forced", *mesh_shape(mesh),
                                 args=args, deadline_s=400), args)
    return out


@pytest.mark.parametrize("tag", sorted(CASES))
def test_world_steps_match_reference(reference_run, worlds, tag):
    z = reference_run
    arch, mesh, kw, _ = CASES[tag]
    cfg = registry.get_smoke_config(arch)
    ranks, _ = worlds[mesh]
    for i in range(STEPS):
        prefix = f"{tag}step{i + 1}"
        got = {k[len(prefix) + 1:]: v for k, v in ranks[0].items() if k.startswith(prefix + "/")}
        m = tree(got, "metrics/")
        check_metrics(m, tree(z, f"{tag}metrics{i}/"), "gspmd", (tag, i))
        for r in ranks[1:]:
            for k in ("loss", "grad_norm"):
                torch.testing.assert_close(r[f"{prefix}/metrics/{k}"], m[k], rtol=0, atol=0)
        state = convert.train_state_from_reference(tree(got, "state/"), cfg, "cpu")
        after = convert.train_state_from_reference(tree(z, f"{tag}state{i + 1}/"), cfg, "cpu")
        before = convert.train_state_from_reference(
            tree(z, tag + ("init/" if i == 0 else f"state{i}/")), cfg, "cpu")
        assert state["step"] == after["step"] == i + 1
        check_state(state, after, (tag, i + 1), False, before=before)
        check_monitor(state, after)


def _flat(ranks, prefix):
    return {k[len(prefix):]: v for k, v in ranks[0].items() if k.startswith(prefix)}


def test_a_checkpoint_resumes_bit_for_bit(worlds):
    ranks, _ = worlds[CKPT_MESH]
    for i in range(2, CKPT_STEPS + 1):
        run = _flat(ranks, f"ckpt/run/step{i}/")
        resumed = _flat(ranks, f"ckpt/resumed/step{i}/")
        assert sorted(run) == sorted(resumed) and run
        for k, v in run.items():
            assert torch.equal(v, resumed[k]), (i, k)


def test_a_rank_reads_its_blocks_and_the_writer_holds_one_leaf(worlds):
    """No rank holds the whole state: rank 0 writes the gathered leaves one
    at a time (the largest it held is the largest leaf of the archive), and
    a rank's restore copies out of the file its own param and optimizer
    blocks, plus the step and the monitor's few rows, and never loads the
    archive whole (the worker bars ``np.load``)."""
    ranks, args = worlds[CKPT_MESH]
    total, peak = (int(v) for v in ranks[0]["ckpt/save"])
    saved = _flat(ranks, "ckpt/run/step1/state/")
    assert total == sum(v.numel() * v.element_size() for v in saved.values())
    assert peak == max(v.numel() * v.element_size() for v in saved.values()) < total / 4
    for r in ranks:
        read, mine = (int(v) for v in r["ckpt/read"])
        assert mine <= read <= mine + 1024, (read, mine)
        assert read < total / 2, (read, total)


def test_the_checkpoint_holds_global_leaves_one_process_restores(worlds):
    ranks, args = worlds[CKPT_MESH]
    ck = Checkpointer(args["ckpt"]["directory"])
    assert ck.latest_step() == 1
    assert ck.manifest(1)["extra"] == {"dp": CKPT_MESH[0], "tp": CKPT_MESH[1]}
    saved = _flat(ranks, "ckpt/run/step1/state/")
    template = tree(saved, "")
    restored = W.flat(ck.restore(1, template, "cpu", dp=CKPT_MESH[0]), "")
    assert sorted(k.lstrip("/") for k in restored) == sorted(saved)
    for k, v in restored.items():
        assert torch.equal(v, saved[k.lstrip("/")]), k
    # the global params are the full-width leaves of the smoke config
    cfg = registry.get_smoke_config(CKPT_ARCH)
    embed = saved["params/embed"]
    assert tuple(embed.shape) == (cfg.vocab, cfg.d_model)
    assert np.isfinite(embed.numpy()).all()
    with pytest.raises(ValueError, match="dp=2"):
        ck.restore(1, template, "cpu", dp=1)
