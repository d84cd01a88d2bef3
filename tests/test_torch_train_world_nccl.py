"""The multi-process trainer on NCCL, one card a rank, against the
stacked-rows trainer on one card.

These need as many NVIDIA cards as the world has ranks (NCCL puts no two
ranks of one communicator on one card) and skip otherwise.  On a node of
four cards, from the repository root:

    python -m pytest -q -m cuda tests/test_torch_train_world_nccl.py

The worlds are ``test_torch_train_world.py``'s gloo worlds on the cards
(``tests/torch_dist_worker.py``'s ``train`` scenario): every grad-sync
mode with AdamW, and four of them with Lion or SGD, 3 steps of the smoke
``llama3.2-1b`` at ``microbatches`` 2; ``compressed`` runs the
``device_fused`` executor, whose int8 combine is the ``mrd_combine``
kernel.  The parent runs the stacked-rows trainer on card 0 on the same
global batches, TF32 off.  A world rank computes its shard's gradient
with the kernels the stacked trainer runs for that rank's row (the same
``[B / dp, ...]`` shapes), and the syncs' stages are single rounded
elementwise operations on both (the kernel is exact), so each rank
equals the sim's row bit for bit, with the module docstring's exception
of ``test_torch_train_world.py`` (a non-owner's optimizer rows).  This
file imports neither JAX nor the reference package.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402
from test_torch_train_world import CONFIGS, STEPS, TAGS, check_rank  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", params=[3, 4], ids=lambda p: f"p{p}")
def nccl_world(request, tmp_path_factory):
    p = request.param
    if not torch.cuda.is_available() or torch.cuda.device_count() < p:
        pytest.skip(f"needs {p} CUDA devices, one a rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sim = W.to(W.sim_train(p, CONFIGS, STEPS, 2 * p, device="cuda"), "cpu")
    ranks = W.run_world(tmp_path_factory.mktemp(f"nccl_train{p}"), "train", (p,), ("data",),
                        args={"dp": p, "configs": CONFIGS, "steps": STEPS, "batch": 2 * p},
                        device="cuda", deadline_s=600, pg_timeout_s=300)
    return p, ranks, sim


@pytest.mark.parametrize("tag", TAGS)
def test_every_nccl_rank_equals_the_sims_row(nccl_world, tag):
    p, ranks, sim = nccl_world
    for i in range(1, STEPS + 1):
        prefix = f"{tag}/step{i}"
        for r, got in enumerate(ranks):
            check_rank(got, sim, prefix, tag, p, r)
        sent = sum(int(got[f"{prefix}/monitor_msgs"]) for got in ranks)
        assert sent == int(sim[f"{prefix}/monitor_msgs"]), (prefix, sent)
