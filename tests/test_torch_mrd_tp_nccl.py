"""The MRD grad-sync modes at ``tp`` > 1 and the ready-bucket overlap as
NCCL worlds, one card a coordinate, against the stacked-rows trainer on
card 0.

These need four NVIDIA cards (NCCL puts no two ranks of one communicator
on one card) and skip otherwise.  On a node of four cards, from the
repository root:

    python -m pytest -q -m cuda tests/test_torch_mrd_tp_nccl.py

They rerun the ``(2, 2)`` world of ``test_torch_mrd_tp.py``
(``tests/torch_dist_worker.py``'s ``mrd_tp_forced``, the same cases and
checks) and the overlap worlds of ``test_torch_overlap.py``
(``overlap_world``) on the cards.  There is no reference on that
machine, so the stacked-rows step of the same mode at dp 2 on card 0
takes its place: its states lie over the flat layout of the whole
params, as the reference's rows do, so each world step starts from its
state before the step mapped onto the coordinate (teacher-forced) and is
held to its state after by ``test_torch_mrd_tp``'s rules (the exact
modes within 5e-4 but for the gradient ties, ``compressed`` by the int8
bound of the stacked ``mrd_zero1`` gradient and the EF invariant bit for
bit); the replicated leaves stay bit-equal across the model ranks, a
checkpoint resumes bit for bit.  ``--overlap`` equals ``--no-overlap``
bit for bit in worlds of ``(4,)`` and ``(2, 2)`` cards.  TF32 is off.
This file imports neither JAX nor the reference package.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402

pytestmark = pytest.mark.cuda
STEPS, MESH = 2, (2, 2)
CASES = {t: c for t, c in W.MRD_TP_CASES.items() if c[2] == MESH}
FREE_TAG, CKPT_STEPS = "llama-compressed-free/", 3


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices, one a rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def batches(cfg, n: int, dp: int) -> list:
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline

    pipe = SyntheticPipeline(cfg, DataConfig(batch=2 * dp, seq_len=16, seed=0), "cuda")
    return [W.to(pipe.next_batch(), "cpu") for _ in range(n)]


def stacked_runs():
    """Every case's stacked-rows steps at dp 2 on card 0 from seed 0:
    [(state before, state after, global batch)] (stacked layout, on the
    CPU) and each step's metrics."""
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import convert

    runs, metrics = {}, {}
    for tag, (arch, mode, _, kw) in CASES.items():
        cfg = registry.get_smoke_config(arch)
        step = step_lib.make_train_step(cfg, W.mrd_tcfg(mode, **kw), dp=MESH[0], device="cuda")
        state = step.init_state(torch.Generator(device="cuda").manual_seed(0))
        steps = []
        for i, b in enumerate(batches(cfg, STEPS, MESH[0])):
            # copies: the step updates the optimizer rows in place
            before = W.to(copy.deepcopy(convert.train_state_to_reference(state)), "cpu")
            state, m = step(state, W.to(b, "cuda"))
            after = W.to(copy.deepcopy(convert.train_state_to_reference(state)), "cpu")
            steps.append((convert.train_state_from_reference(before, cfg, "cpu"),
                          convert.train_state_from_reference(after, cfg, "cpu"), b))
            metrics[f"{tag}{i}"] = {k: v.detach().cpu() for k, v in m.items()}
        runs[tag] = (arch, W.mrd_tcfg(mode, **kw), steps)
    return runs, metrics


@pytest.fixture(scope="module")
def world(cards, tmp_path_factory):
    from repro_torch.configs import registry

    runs, metrics = stacked_runs()
    llama = registry.get_smoke_config("llama3.2-1b")
    root = tmp_path_factory.mktemp("nccl_mrd_tp")
    args = {"runs": runs,
            "free": {FREE_TAG: ("llama3.2-1b", W.mrd_tcfg("compressed"), batches(llama, 3, 2))},
            "ckpt": {"arch": "llama3.2-1b", "tcfg": W.mrd_tcfg("compressed"),
                     "directory": str(root / "ckpt"), "batches": batches(llama, CKPT_STEPS, 2)}}
    recs = W.run_world(root / "world", "mrd_tp_forced", MESH, ("data", "model"), args=args,
                       device="cuda", deadline_s=600, pg_timeout_s=300)
    return recs, metrics


@pytest.mark.parametrize("tag", sorted(CASES))
def test_nccl_mrd_tp_world_matches_the_stacked_step(world, tag):
    from repro_torch.configs import registry

    recs, metrics = world
    arch, mode, mesh, _ = CASES[tag]
    exact = W.MRD_EXACT_OF.get(tag)
    W.check_mrd_case(recs, mesh, tag, mode, registry.get_smoke_config(arch),
                     lambda i: metrics[f"{tag}{i}"],
                     float(metrics[f"{exact}0"]["grad_norm"]) if exact else None, STEPS)


def test_nccl_replicated_leaves_stay_equal_and_a_checkpoint_resumes(world):
    W.check_mrd_free_and_ckpt(world[0], FREE_TAG, CKPT_STEPS)


@pytest.fixture(scope="module")
def overlap_worlds(cards, tmp_path_factory):
    return {shape: W.run_world(tmp_path_factory.mktemp("nccl_overlap"), "overlap_world", shape,
                               names, args={"arch": "llama3.2-1b", "steps": 2,
                                            "batch": 2 * shape[0]},
                               device="cuda", deadline_s=600, pg_timeout_s=300)
            for shape, names in (((4,), ("data",)), ((2, 2), ("data", "model")))}


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
@pytest.mark.parametrize("mode", W.OVERLAP_MODES)
def test_nccl_overlap_equals_post_backward(overlap_worlds, shape, mode):
    for r, rec in enumerate(overlap_worlds[shape]):
        off, on = W.part(rec, f"{mode}/off/"), W.part(rec, f"{mode}/on/")
        assert sorted(off) == sorted(on) and off
        for k, v in off.items():
            assert torch.equal(v, on[k]), (shape, mode, r, k)
