"""The port's ``device`` and ``device_fused`` executors (``torch.distributed``
point-to-point ops, one process a rank) in gloo worlds on the CPU.

Each world is spawned once (``tests/torch_dist_worker.py``) under a
deadline of its own and fails, rather than hangs, on a stage the ranks
disagree on.  On the CPU the device executors and the sim compute the
same operations on the same rows (``x + recv``; the same ``quantize`` and
plain dequant-add, which is also what ``mrd_combine`` does on a CPU
tensor), so every rank's result must equal the sim's row bit for bit;
against the reference the results are held to a tolerance, and against a
float64 sum to a quantization bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_worker as W  # noqa: E402
from repro.collectives import plans as ref_plans  # noqa: E402
from repro.collectives import schedules as ref_schedules  # noqa: E402

SEED = 7
ONE_AXIS_KEYS = ([f"mrd_{op}" for op in W.OPS] + ["mrd_blocking"]
                 + [f"{k}_{tf}" for tf in W.TRANSFORMS
                    for k in ("mrd", "rabenseifner", "rs", "rsag")]
                 + [f"tree_{s}_{tf}" for s in ("mrd", "rabenseifner") for tf in W.TRANSFORMS]
                 + ["pipeline"])


@pytest.fixture(scope="module", params=[3, 5, 8], ids=lambda p: f"p{p}")
def one_axis(request, tmp_path_factory):
    p = request.param
    ranks = W.run_world(tmp_path_factory.mktemp(f"world{p}"), "one_axis", (p,), ("r",),
                        args={"p": p, "seed": SEED})
    return p, ranks, W.sim_one_axis(p, SEED)


@pytest.mark.parametrize("ex", W.EXECUTORS)
@pytest.mark.parametrize("key", ONE_AXIS_KEYS)
def test_device_equals_sim_bit_for_bit(one_axis, key, ex):
    _, ranks, sim = one_axis
    expect = W.entries(sim, key)
    assert expect
    for r, got in enumerate(ranks):
        got = W.entries(got, key, ex)
        assert set(got) == set(expect), (sorted(got), sorted(expect))
        for k, v in expect.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v[r]), (r, k)


@pytest.mark.parametrize("ex", W.EXECUTORS)
def test_pipeline_admissions_equal_run_buffers(one_axis, ex):
    """Late admission (2 and 3 stages behind) changes no bit of any bucket."""
    _, ranks, _ = one_axis
    for got in ranks:
        for k in range(3):
            assert torch.equal(got[f"pipeline_{k}_{ex}"], got[f"run_buffers_{k}_{ex}"])


def test_int8_block_kwarg_reaches_the_device_plan(one_axis):
    """``block=128`` travels through the plan's transform kwargs; 128-blocks
    take the plain combine on device_fused, and equal the sim's."""
    _, ranks, sim = one_axis
    for r, got in enumerate(ranks):
        assert torch.equal(got["int8_block128"], sim["int8_block128"][r])
    assert not torch.equal(sim["int8_block128"], sim["rabenseifner_int8"])


@pytest.mark.parametrize("transform", W.TRANSFORMS)
@pytest.mark.parametrize("schedule", ["mrd", "rabenseifner"])
def test_device_allreduce_holds_to_the_reference(one_axis, schedule, transform):
    p, ranks, _ = one_axis
    X = W.stacked_inputs(p, W.one_axis_length(p), SEED)
    plan = ref_plans.allreduce_plan(schedule=schedule, transform=transform, p=p, executor="sim")
    ref = np.asarray(jax.jit(plan.run)(jnp.asarray(X)))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{schedule}_{transform}_device_fused"].numpy(), ref[r],
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Chained plans on a (2, 3) mesh
# ---------------------------------------------------------------------------

MESH = (2, 3)
MESH_NAMES = ("pod", "data")
N2 = 2048  # whole 256-blocks after two halvings (p0 2 on each axis)
CHAINED = {"mrd": ("mrd", ("pod", "data")), "rabenseifner": ("rabenseifner", ("pod", "data")),
           "hierarchical": ("hierarchical", ("data", "pod"))}


@pytest.fixture(scope="module")
def two_axis(tmp_path_factory):
    return W.run_world(tmp_path_factory.mktemp("mesh23"), "two_axis", MESH, MESH_NAMES,
                       args={"seed": SEED, "n": N2})


@pytest.mark.parametrize("ex", W.EXECUTORS)
@pytest.mark.parametrize("transform", W.TRANSFORMS)
@pytest.mark.parametrize("name", sorted(CHAINED))
def test_chained_plans_on_a_mesh(two_axis, name, transform, ex):
    """Every rank equal, equal bit for bit to the per-axis sim plans, and
    within fp32 rounding (identity) or the int8 grid's bound of the
    float64 sum."""
    schedule, axes = CHAINED[name]
    X = W.stacked_inputs(len(two_axis), N2, SEED)
    sim = W.sim_chained(torch.from_numpy(X).reshape(*MESH, N2), schedule, axes, transform,
                        MESH_NAMES)
    key = f"{name}_{transform}_{ex}"
    outs = [got[key] for got in two_axis]
    for g, out in enumerate(outs):
        assert torch.equal(out, outs[0]), g
        assert torch.equal(out, sim[g // MESH[1], g % MESH[1]]), g
    exact = X.astype(np.float64).sum(0)
    if transform == "identity":
        atol = 1e-5
    else:  # each reducing stage rounds both operands to the grid: amax / 254 each
        reducing = sum(row[0] in ("bshift", "butterfly", "rs")
                       for row in two_axis[0][f"table_{name}"])
        atol = 2 * reducing * np.abs(X).sum(0).max() / 254
    np.testing.assert_allclose(outs[0].numpy(), exact, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(CHAINED))
def test_chained_stage_table_is_the_references_per_axis_stages(two_axis, name):
    schedule, axes = CHAINED[name]
    sizes = [MESH[MESH_NAMES.index(a)] for a in axes]
    ref = [(st.kind, st.pairs, st.distance, st.payload_fraction, ph.collective, ph.axis_index,
            sizes[ph.axis_index])
           for ph in ref_schedules.get_schedule(schedule).phases(len(axes))
           for st in ph.stages(sizes[ph.axis_index])]
    for got in two_axis:
        assert got[f"table_{name}"] == ref
        assert bool(got[f"hashable_{name}"])


# ---------------------------------------------------------------------------
# The ConvergenceMonitor over ("pod", "data") on a (2, 2) mesh
# ---------------------------------------------------------------------------


def test_monitor_exact_mode_two_axis_mesh(tmp_path):
    """The reference's assertions (``tests/test_monitor_multiaxis.py``):
    every rank certifies the same values, each the max over ranks of one
    latch step's metric (4 x base[k]), and the monitor detects; the chained
    cycle is 1 + 1 butterfly stages, one scalar permute a step."""
    steps = 12
    ranks = W.run_world(tmp_path, "monitor", (2, 2), MESH_NAMES, args={"steps": steps})
    vals = np.stack([r["vals"].numpy() for r in ranks])
    dones = np.stack([r["dones"].numpy() for r in ranks])
    assert np.array_equal(vals, np.broadcast_to(vals[:1], vals.shape))
    base = np.geomspace(1.0, 1e-6, steps).astype(np.float32)
    certified = np.unique(vals[0])
    certified = certified[certified < 1e29]
    assert certified.size
    for v in certified:
        assert np.isclose(4.0 * base, v, rtol=1e-5).any(), v
    assert dones[:, -1].all()
    for r in ranks:
        assert int(r["cycle_length"]) == 2
        assert r["permutes"].tolist() == [1] * steps
        assert (r["numel"] == 1).all()


def test_a_mismatched_stage_fails_instead_of_hanging(tmp_path):
    """Two ranks that disagree on a stage's pairs each wait for a message
    that never comes: the world fails within its deadline."""
    with pytest.raises(W.WorldFailed, match="Timed out|still running"):
        W.run_world(tmp_path, "mismatched", (2,), ("r",), deadline_s=30, pg_timeout_s=3)
