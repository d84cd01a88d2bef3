"""The port's schedules, cost model and sim-executor collectives against
the reference's: the rabenseifner and hierarchical families, the volume
counts and the alpha-beta model (exact), the rabenseifner allreduce,
``run_bucketed``/``tree_allreduce`` and ``BucketPipeline`` on the sim
executor (held to the reference with a tolerance, and to the port's own
``run``/``run_buffers`` bit for bit), and the int8 ``block`` option.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.collectives import plans as ref_plans  # noqa: E402
from repro.collectives import schedules as ref_s  # noqa: E402
from repro.collectives import transforms as ref_tf  # noqa: E402
from repro.serving import termination as ref_term  # noqa: E402
from repro_torch.collectives import plans, transforms  # noqa: E402
from repro_torch.collectives import schedules as s  # noqa: E402
from repro_torch.serving import termination  # noqa: E402

STAGE_FNS = ("allreduce_schedule", "reduce_scatter_schedule", "allgather_schedule",
             "rabenseifner_schedule")


def _desc(stages):
    return [(st.kind, st.pairs, st.distance, st.payload_fraction) for st in stages]


@pytest.mark.parametrize("p", range(1, 34))
def test_schedules_and_volumes_equal_the_reference(p):
    assert s.is_power_of_two(p) == ref_s.is_power_of_two(p)
    for fn in STAGE_FNS:
        ours, ref = getattr(s, fn)(p), getattr(ref_s, fn)(p)
        assert _desc(ours) == _desc(ref), fn
        for n in (1, 1000, 2**20 + 3):
            assert s.schedule_volume(ours, n) == ref_s.schedule_volume(ref, n)
            for r in range(p):
                assert s.per_rank_volume(ours, n, r) == ref_s.per_rank_volume(ref, n, r)
        assert s.schedule_messages(ours) == ref_s.schedule_messages(ref)
    assert not s.is_power_of_two(0) and not s.is_power_of_two(-4)


@pytest.mark.parametrize("alpha,beta", [(1e-6, 1 / 50e9), (3.7e-5, 2.5e-12), (0.0, 1e-9)])
def test_alpha_beta_times_equal_the_reference(alpha, beta):
    link, ref_link = s.LinkModel(alpha, beta), ref_s.LinkModel(alpha, beta)
    for p in (1, 2, 3, 5, 8, 12, 16, 33, 64, 256):
        for n_bytes in (8, 4096, 100 * 2**20):
            for fn in ("allreduce_schedule", "rabenseifner_schedule", "reduce_scatter_schedule"):
                assert s.schedule_time(getattr(s, fn)(p), n_bytes, link) == \
                    ref_s.schedule_time(getattr(ref_s, fn)(p), n_bytes, ref_link)
            assert s.ring_allreduce_time(p, n_bytes, link) == \
                ref_s.ring_allreduce_time(p, n_bytes, ref_link)
            assert s.tree_allreduce_time(p, n_bytes, link) == \
                ref_s.tree_allreduce_time(p, n_bytes, ref_link)


def test_link_models_are_the_h100_datasheet_rates():
    """NVLink 4 at 450 GB/s a direction and an NDR port at 50 GB/s; no TPU
    constant is carried over."""
    nv, ib = s.LinkModel.h100_nvlink(), s.LinkModel.ndr_infiniband()
    assert nv.beta_s_per_byte == 1 / 450e9 and ib.beta_s_per_byte == 1 / 50e9
    assert 0 < nv.alpha_s < ib.alpha_s
    assert not hasattr(s.LinkModel, "tpu_v5e_ici") and not hasattr(s.LinkModel, "dcn")


@pytest.mark.parametrize("n_axes", [1, 2, 3])
@pytest.mark.parametrize("name", ["mrd", "rabenseifner", "hierarchical"])
def test_phase_lists_and_min_axes_equal_the_reference(name, n_axes):
    assert set(s.SCHEDULES) == set(ref_s.SCHEDULES)
    fam, ref = s.get_schedule(name), ref_s.get_schedule(name)
    assert fam.min_axes == ref.min_axes
    try:
        want = [(ph.collective, ph.axis_index) for ph in ref.phases(n_axes)]
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            fam.phases(n_axes)
        assert str(ours.value) == str(e)
        return
    assert [(ph.collective, ph.axis_index) for ph in fam.phases(n_axes)] == want
    if name == "hierarchical":  # innermost axis first: its reduce-scatter leads
        assert want[0] == ("reduce_scatter", 0) and want[n_axes - 1] == ("allreduce", n_axes - 1)


def _x(p, n, seed):
    return np.random.default_rng(seed).standard_normal((p, n)).astype(np.float32)


@pytest.mark.parametrize("transform", ["identity", "int8"])
@pytest.mark.parametrize("p", range(2, 10))
def test_sim_rabenseifner_allreduce(p, transform):
    """Against the reference within 1e-5; against the port's own
    reduce-scatter then all-gather bit for bit; every rank equal."""
    p0 = s.pivot(p)[0]
    x = _x(p, p0 * 256 * 3, 100 + p)
    plan = plans.allreduce_plan(schedule="rabenseifner", p=p, transform=transform)
    assert plan.executor == "sim"
    ref = ref_plans.allreduce_plan(schedule="rabenseifner", p=p, transform=transform)
    out = plan.run(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(ref.run)(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    rs = plans.reduce_scatter_plan(p=p, transform=transform).run(torch.from_numpy(x))
    assert torch.equal(out, plans.allgather_plan(p=p).run(rs))
    assert all(torch.equal(out[r], out[0]) for r in range(p))
    assert plan.pad_quantum() == ref.pad_quantum()
    if transform == "identity":
        np.testing.assert_allclose(out[0].numpy(), x.astype(np.float64).sum(0), atol=1e-5)


def _mixed_tree(p, seed):
    """A tree of fp32 leaves of mixed shapes and sizes, stacked [p, ...]."""
    rng = np.random.default_rng(seed)
    shapes = {"emb": (40, 24), "blk": {"w1": (24, 48), "b1": (48,), "w2": (48, 24)},
              "norm": (24,), "scalar_like": (1,), "odd": (3, 5, 7)}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return rng.standard_normal((p,) + node).astype(np.float32)

    return build(shapes)


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


@pytest.mark.parametrize("bucket_bytes", [None, 4096])
@pytest.mark.parametrize("transform", ["identity", "int8"])
@pytest.mark.parametrize("schedule", ["mrd", "rabenseifner"])
@pytest.mark.parametrize("p", [3, 5])
def test_tree_allreduce_and_run_bucketed(p, schedule, transform, bucket_bytes):
    np_tree = _mixed_tree(p, p)
    tree = _to(np_tree, torch.from_numpy)
    out = plans.tree_allreduce(tree, schedule=schedule, transform=transform, p=p,
                               bucket_bytes=bucket_bytes)
    ref = jax.jit(lambda t: ref_plans.tree_allreduce(
        t, schedule=schedule, transform=transform, p=p, bucket_bytes=bucket_bytes))(
        _to(np_tree, jnp.asarray))
    got, want = _leaves(out), _leaves(ref)
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == np_tree_shape(np_tree, k) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    # bit for bit against run() on each packed bucket
    from repro_torch.collectives import buckets

    plan = plans.allreduce_plan(schedule=schedule, transform=transform, p=p)
    layout = buckets.build_layout(tree, bucket_bytes=bucket_bytes, quantum=plan.pad_quantum(),
                                  stacked=p)
    assert len(layout.buckets) == (1 if bucket_bytes is None else
                                   len(ref_layout(np_tree, bucket_bytes, plan.pad_quantum(), p)))
    per_bucket = [plan.run(b) for b in buckets.pack(tree, layout)]
    for k, v in _leaves(buckets.unpack(per_bucket, layout)).items():
        assert torch.equal(v, got[k]), k
    assert all(torch.equal(v, _leaves(plan.run_bucketed(tree, layout=layout))[k])
               for k, v in got.items())


def np_tree_shape(np_tree, key):
    node = np_tree
    for part in key.split("/"):
        node = node[part]
    return node.shape


def ref_layout(np_tree, bucket_bytes, quantum, p):
    from repro.collectives import buckets as ref_buckets

    return ref_buckets.build_layout(_to(np_tree, jnp.asarray), bucket_bytes=bucket_bytes,
                                    quantum=quantum, stacked=p).buckets


@pytest.mark.parametrize("order", ["staggered", "reversed"])
@pytest.mark.parametrize("schedule", ["mrd", "rabenseifner"])
@pytest.mark.parametrize("p", [3, 6])
def test_bucket_pipeline_equals_run_buffers(p, schedule, order):
    """Buckets admitted while others are in flight, in two orders, end bit
    for bit where run_buffers leaves them (int8: the lossy transform)."""
    q = plans.allreduce_plan(schedule=schedule, transform="int8", p=p).pad_quantum()
    bufs = [torch.from_numpy(_x(p, q * k, 10 * p + k)) for k in (1, 3, 2, 1)]
    plan = plans.allreduce_plan(schedule=schedule, transform="int8", p=p)
    want = plan.run_buffers(list(bufs))
    pipe = plan.pipeline()
    keys = list(range(len(bufs))) if order == "staggered" else list(reversed(range(len(bufs))))
    for i, k in enumerate(keys):
        pipe.admit(k, bufs[k])
        for _ in range(i % 3):
            pipe.advance()
    with pytest.raises(ValueError, match="admitted twice"):
        pipe.admit(keys[0], bufs[keys[0]])
    done = pipe.drain()
    assert sorted(done) == list(range(len(bufs)))
    for k, w in enumerate(want):
        assert torch.equal(done[k], w), k
    assert pipe.drain() == {}
    # a length off the quantum: refused at admission (reduce-scatter
    # phases) or by the int8 encode (allreduce phases)
    with pytest.raises(ValueError, match=r"pad_quantum|quantize needs n % 256"):
        plan.pipeline().admit("short", torch.zeros((p, q + 1)))


@pytest.mark.parametrize("block", [64, 128, 512])
def test_int8_block_option_equals_the_reference(block):
    p = 5
    x = _x(p, 4 * block * 2, block)
    for schedule in ("mrd", "rabenseifner"):
        plan = plans.allreduce_plan(schedule=schedule, transform="int8", p=p, block=block)
        ref = ref_plans.allreduce_plan(schedule=schedule, transform="int8", p=p, block=block)
        assert plan.transform_kwargs == (("block", block),)
        assert plan._transform().block == block == plan._transform().quantum
        assert plan.pad_quantum() == ref.pad_quantum()
        np.testing.assert_allclose(plan.run(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax.jit(ref.run)(jnp.asarray(x))), rtol=0,
                                   atol=1e-5)
    err = transforms.quantization_error(torch.from_numpy(x[0]), block)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_tf.quantization_error(
        jnp.asarray(x[0]), block)), rtol=0, atol=1e-7)
    assert transforms.resolve_transform("int8", block=block).block == block


def test_plan_binding_errors_are_the_references():
    with pytest.raises(ValueError, match=r"bind exactly one of axes= \(device\) or p= \(sim\)"):
        plans.allreduce_plan()
    with pytest.raises(ValueError, match="bind exactly one"):
        plans.tree_allreduce({}, axes=("r",), p=2)
    with pytest.raises(ValueError, match="mesh"):
        plans.allreduce_plan(axes=("r",))
    with pytest.raises(ValueError, match="needs an axis name and a mesh"):
        plans.allreduce_plan(p=3, executor="device_fused").run(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="needs >= 2 axes, got 1"):
        plans.allreduce_plan(schedule="hierarchical", p=4).cycle_length()
    with pytest.raises(ValueError, match="has a reduce_scatter phase"):
        plans.allreduce_plan(schedule="rabenseifner", p=4).cycle_length()
    with pytest.raises(ValueError, match="run_bucketed needs an allreduce-schedule plan"):
        plans.reduce_scatter_plan(p=2).run_bucketed({"a": torch.zeros(2, 512)})
    assert plans.allreduce_plan(p=3).executor == "sim"


# ---------------------------------------------------------------------------
# Fixed-point serving's termination over every registered schedule
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("dp", [1, 3, 4])
@pytest.mark.parametrize("proto", ["eos_maxlen", "residual_inexact", "residual_interval"])
@pytest.mark.parametrize("schedule", sorted(s.SCHEDULES))
def test_termination_serves_or_raises_where_the_reference_does(schedule, proto, dp, window):
    """Config, cycle length, init and one tick: each succeeds or raises the
    reference's error at the same call."""
    slots = 2
    ours, ref = termination.get_termination(proto), ref_term.get_termination(proto)
    cfg = termination.TerminationConfig(dp=dp, window=window, schedule=schedule)
    rcfg = ref_term.TerminationConfig(dp=dp, window=window, schedule=schedule)
    assert _outcome(lambda: ours.cycle_length(cfg)) == _outcome(lambda: ref.cycle_length(rcfg))
    st = _outcome(lambda: ours.init(cfg, slots, device="cpu"))
    rst = _outcome(lambda: ref.init(rcfg, slots))
    assert st[0] == rst[0] and (st[0] == "ok" or st[1] == rst[1])
    if st[0] != "ok":
        return
    z = np.zeros(slots, np.int64)
    sig = termination.make_signals(
        tokens=torch.from_numpy(z), new_tokens=torch.from_numpy(z), eos=torch.from_numpy(z - 1),
        max_new=torch.from_numpy(z + 9), eps=torch.ones(slots),
        active=torch.ones(slots, dtype=bool),
        admit_tick=torch.from_numpy(z), tick=0, residual=torch.zeros((dp, slots)))
    rsig = ref_term.make_signals(
        tokens=jnp.asarray(z), new_tokens=jnp.asarray(z), eos=jnp.asarray(z - 1),
        max_new=jnp.asarray(z + 9), eps=jnp.ones(slots), active=jnp.ones(slots, bool),
        admit_tick=jnp.asarray(z), tick=0, residual=jnp.zeros((dp, slots)))
    got = _outcome(lambda: ours.tick(st[1], sig, cfg)[1].tolist())
    want = _outcome(lambda: np.asarray(ref.tick(rst[1], rsig, rcfg)[1]).tolist())
    assert got == want
