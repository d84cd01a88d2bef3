"""The port's ``device`` and ``device_fused`` executors on NCCL, one card a
rank, against the sim executor on the CPU.

These need as many NVIDIA cards as the world has ranks (NCCL puts no two
ranks of one communicator on one card) and skip otherwise.  On a node of
four cards, from the repository root:

    python -m pytest -q -m cuda tests/test_torch_collectives_nccl.py

The worlds are the gloo worlds of ``test_torch_collectives_device.py``
(``tests/torch_dist_worker.py``) with the rank-local buffers on the
cards: ``device_fused``'s int8 combine runs the ``mrd_combine`` kernel
there, and every rank's result must still equal the sim's row on the CPU
bit for bit (the kernel is exact, and the stages' other operations are
single rounded elementwise operations on both).  This file imports
neither JAX nor the reference package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402

pytestmark = pytest.mark.cuda

SEED = 11
MESH_NAMES = ("pod", "data")
N2 = 2048


def _cards(world: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices, one a rank")


@pytest.mark.parametrize("p", [3, 4])
def test_one_axis_plans_on_nccl_equal_the_sim(tmp_path, p):
    _cards(p)
    ranks = W.run_world(tmp_path, "one_axis", (p,), ("r",), args={"p": p, "seed": SEED},
                        device="cuda", deadline_s=300, pg_timeout_s=120)
    sim = W.sim_one_axis(p, SEED)
    bases = {k.partition("/")[0] for k in sim}
    for ex in W.EXECUTORS:
        for base in sorted(bases):
            if base == "int8_block128":
                continue
            expect = W.entries(sim, base)
            for r, got in enumerate(ranks):
                got = W.entries(got, base, ex)
                assert set(got) == set(expect), (base, ex)
                for k, v in expect.items():
                    assert torch.equal(got[k], v[r]), (p, ex, r, k)
    for r, got in enumerate(ranks):
        assert torch.equal(got["int8_block128"], sim["int8_block128"][r])


def test_chained_plans_on_a_two_by_two_nccl_mesh(tmp_path):
    _cards(4)
    ranks = W.run_world(tmp_path, "two_axis", (2, 2), MESH_NAMES, args={"seed": SEED, "n": N2},
                        device="cuda", deadline_s=300, pg_timeout_s=120)
    X = torch.from_numpy(W.stacked_inputs(4, N2, SEED)).reshape(2, 2, N2)
    for name, schedule, axes in (("mrd", "mrd", ("pod", "data")),
                                 ("rabenseifner", "rabenseifner", ("pod", "data")),
                                 ("hierarchical", "hierarchical", ("data", "pod"))):
        for tf in W.TRANSFORMS:
            sim = W.sim_chained(X, schedule, axes, tf, MESH_NAMES)
            for ex in W.EXECUTORS:
                for g, got in enumerate(ranks):
                    assert torch.equal(got[f"{name}_{tf}_{ex}"], sim[g // 2, g % 2]), (name, tf, ex)


def test_monitor_over_pod_and_data_on_nccl(tmp_path):
    _cards(4)
    steps = 12
    ranks = W.run_world(tmp_path, "monitor", (2, 2), MESH_NAMES, args={"steps": steps},
                        device="cuda", deadline_s=300, pg_timeout_s=120)
    vals = np.stack([r["vals"].numpy() for r in ranks])
    assert np.array_equal(vals, np.broadcast_to(vals[:1], vals.shape))
    base = np.geomspace(1.0, 1e-6, steps).astype(np.float32)
    certified = [v for v in np.unique(vals[0]) if v < 1e29]
    assert certified and all(np.isclose(4.0 * base, v, rtol=1e-5).any() for v in certified)
    for r in ranks:
        assert bool(r["dones"][-1]) and r["permutes"].tolist() == [1] * steps
