"""The port's MRD schedule, plan state machine and termination protocol
against the reference's.

Integers and control decisions must match exactly: stage tables, the
non-blocking plan's ``flag`` sequence, and ``eos_maxlen`` retire masks
tick by tick.  The reduced inputs are small integers in fp32, so sums and
maxima match exactly too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.collectives import plans as ref_plans  # noqa: E402
from repro.collectives import schedules as ref_schedules  # noqa: E402
from repro.serving import termination as ref_term  # noqa: E402
from repro_torch.collectives import plans, schedules  # noqa: E402
from repro_torch.serving import termination  # noqa: E402


@pytest.mark.parametrize("p", range(1, 18))
def test_mrd_stage_table_matches_reference(p):
    ours = [(st.kind, st.pairs, st.distance) for st in schedules.allreduce_schedule(p)]
    ref = [(st.kind, st.pairs, st.distance) for st in ref_schedules.allreduce_schedule(p)]
    assert ours == ref
    assert schedules.pivot(p) == ref_schedules.pivot(p)


@pytest.mark.parametrize("p", range(2, 18))
def test_mrd_message_and_step_counts_are_the_papers(p):
    p0, mu0, extra = schedules.pivot(p)
    stages = schedules.get_schedule("mrd").phases(1)[0].stages(p)
    assert sum(len(st.pairs) for st in stages) == p0 * mu0 + 2 * extra
    assert len(stages) == mu0 + (2 if extra else 0)


@pytest.mark.parametrize("p", [1, 2, 3, 5, 6, 8])
@pytest.mark.parametrize("op", ["max", "sum"])
def test_plan_step_flags_and_results_match_reference(p, op):
    """Two cycles and a bit of init/step with a contribution that changes
    every call: flags, cycle counts and published results match exactly
    (integers, so sums are exact too)."""
    rng = np.random.default_rng(p)
    ours = plans.allreduce_plan(schedule="mrd", p=p, op=op)
    ref = ref_plans.allreduce_plan(schedule="mrd", p=p, op=op)
    assert ours.cycle_length() == ref.cycle_length()
    vals = rng.integers(-50, 50, size=(2 * ours.cycle_length() + 1, p, 5)).astype(np.float32)
    st = ours.init(torch.from_numpy(vals[0]))
    rst = ref.init(jnp.asarray(vals[0]))
    ref_step = jax.jit(ref.step)
    for v in vals:
        st = ours.step(st, torch.from_numpy(v))
        rst = ref_step(rst, jnp.asarray(v))
        assert st["flag"] == bool(rst["flag"])
        assert st["stage"] == int(rst["stage"])
        assert st["cycles"] == int(rst["cycles"])
        np.testing.assert_array_equal(st["result"].numpy(), np.asarray(rst["result"]))
        np.testing.assert_array_equal(st["buf"].numpy(), np.asarray(rst["buf"]))


@pytest.mark.parametrize("p", [2, 3, 5, 7, 12])
def test_plan_run_is_allreduce(p):
    rng = np.random.default_rng(10 + p)
    x = rng.integers(-9, 9, size=(p, 4)).astype(np.float32)
    for op, red in (("sum", np.sum), ("max", np.max), ("min", np.min)):
        out = plans.allreduce_plan(p=p, op=op).run(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(out, np.broadcast_to(red(x, axis=0), x.shape))
        ref = ref_plans.allreduce_plan(p=p, op=op).run(jnp.asarray(x))
        np.testing.assert_array_equal(out, np.asarray(ref))
    blocking = plans.allreduce_plan(p=p, op="sum").run_blocking(torch.from_numpy(x))
    np.testing.assert_array_equal(blocking.numpy(), np.broadcast_to(x.sum(0), x.shape))


def _signals(rng, slots, tick, state):
    """A random but consistent signal sequence: slots switch on/off, are
    re-admitted, hit EOS or their budget."""
    active, admit, new_tok, max_new, eos = state
    for s in range(slots):
        if not active[s] and rng.random() < 0.5:
            active[s], admit[s], new_tok[s] = True, tick, 1
            max_new[s], eos[s] = rng.integers(2, 7), rng.integers(-1, 4)
        elif active[s] and rng.random() < 0.1:
            active[s] = False
    new_tok[active] += 1
    tokens = rng.integers(0, 4, size=slots)
    return dict(tokens=tokens, new_tokens=new_tok.copy(), eos=eos.copy(),
                max_new=max_new.copy(), active=active.copy(), admit_tick=admit.copy(),
                tick=tick)


@pytest.mark.parametrize("dp", [1, 3, 5])
def test_eos_maxlen_retire_masks_match_reference_tick_by_tick(dp):
    slots, ticks = 6, 40
    rng = np.random.default_rng(dp)
    state = (np.zeros(slots, bool), np.zeros(slots, np.int64), np.zeros(slots, np.int64),
             np.ones(slots, np.int64), np.full(slots, -1, np.int64))
    ours, ref = termination.get_termination("eos_maxlen"), ref_term.get_termination("eos_maxlen")
    cfg, rcfg = termination.TerminationConfig(dp=dp), ref_term.TerminationConfig(dp=dp)
    st, rst = ours.init(cfg, slots, device="cpu"), ref.init(rcfg, slots)
    ref_tick = jax.jit(ref.tick, static_argnums=2)
    n_retired = 0
    for t in range(ticks):
        sig = _signals(rng, slots, t, state)
        tsig = termination.make_signals(
            **{k: (torch.from_numpy(np.asarray(v)) if k != "tick" else v) for k, v in sig.items()},
            eps=torch.zeros(slots), residual=torch.zeros((dp, slots)))
        rsig = ref_term.make_signals(
            **{k: jnp.asarray(v) for k, v in sig.items()},
            eps=jnp.zeros(slots, jnp.float32), residual=jnp.zeros((dp, slots), jnp.float32))
        st, retire = ours.tick(st, tsig, cfg)
        rst, rretire = ref_tick(rst, rsig, rcfg)
        np.testing.assert_array_equal(retire.numpy(), np.asarray(rretire))
        np.testing.assert_array_equal(st["certified"].numpy(), np.asarray(rst["certified"]))
        assert st["t_latch"] == int(rst["t_latch"])
        state[0][retire.numpy()] = False  # the engine deactivates retired slots
        n_retired += int(retire.sum())
    assert n_retired > 0


# ---------------------------------------------------------------------------
# int8 wire format, reduce-scatter / all-gather plans, buckets (the
# gradient sync's collectives).  Same inputs on both sides; every
# comparison is exact: quantize divides by a correctly rounded scale and
# rounds half to even in both frameworks, and the plans' sums and
# dequant-accumulates are single rounded fp32 operations on both sides.
# ---------------------------------------------------------------------------

from repro.collectives import buckets as ref_buckets  # noqa: E402
from repro.collectives import transforms as ref_tf  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch.collectives import buckets, transforms  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import reference_tree  # noqa: E402


def _quant_cases():
    """Random blocks, an all-zero block, a block whose values sit exactly
    on +-amax, and a block of half-way points (amax 127 -> scale 1.0, so
    v.5 must round half to even)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(256 * 6) * 3).astype(np.float32)
    x[256:512] = 0.0
    x[512:768] = np.where(rng.random(256) < 0.5, 2.5, -2.5)
    x[512] = 2.5
    halves = (np.arange(256) % 254 - 126.5).astype(np.float32)
    halves[0], halves[1] = 127.0, -127.0
    x[768:1024] = halves
    x[1024:1280] *= 1e-30  # tiny scales
    return x


def test_quantize_bytes_and_scales_equal_the_reference():
    x = _quant_cases()
    q, s = transforms.quantize(torch.from_numpy(x))
    rq, rs = ref_tf.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s[1] == 1.0 and (q[256:512] == 0).all()  # all-zero block
    assert set(q[768:1024].tolist()) >= {127, -127, -126, 126, 2, -2}  # ties to even
    np.testing.assert_array_equal(transforms.dequantize(q, s).numpy(),
                                  np.asarray(ref_tf.dequantize(rq, rs)))
    # stacked rows quantize row by row
    q2, s2 = transforms.quantize(torch.from_numpy(x.reshape(2, -1)))
    np.testing.assert_array_equal(q2.numpy().reshape(-1), q.numpy())
    np.testing.assert_array_equal(s2.numpy().reshape(-1), s.numpy())
    assert transforms.wire_bytes_factor() == ref_tf.wire_bytes_factor()


def test_ef_roundtrip_equals_the_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1024) * 2).astype(np.float32)
    ef = (rng.standard_normal(1024) * 1e-2).astype(np.float32)
    send, new_ef = transforms.ef_roundtrip(torch.from_numpy(x), torch.from_numpy(ef))
    rsend, rnew = ref_tf.ef_roundtrip(jnp.asarray(x), jnp.asarray(ef))
    np.testing.assert_array_equal(send.numpy(), np.asarray(rsend))
    np.testing.assert_array_equal(new_ef.numpy(), np.asarray(rnew))


def _stacked(p, n, seed):
    return np.random.default_rng(seed).standard_normal((p, n)).astype(np.float32)


@pytest.mark.parametrize("transform", ["identity", "int8"])
@pytest.mark.parametrize("p", range(2, 10))
def test_rs_ag_allreduce_plans_match_reference(p, transform):
    p0 = schedules.pivot(p)[0]
    n = p0 * 256 * 2
    x = _stacked(p, n, p)
    rs = plans.reduce_scatter_plan(p=p, transform=transform)
    rrs = ref_plans.reduce_scatter_plan(p=p, executor="sim", transform=transform)
    assert rs.pad_quantum() == rrs.pad_quantum()
    assert [(st.kind, st.pairs, st.distance, st.payload_fraction) for st, *_ in rs.bound_stage_table()] \
        == [(st.kind, st.pairs, st.distance, st.payload_fraction)
            for st, *_ in rrs.bound_stage_table()]
    red = rs.run(torch.from_numpy(x))
    np.testing.assert_array_equal(red.numpy(), np.asarray(rrs.run(jnp.asarray(x))))
    ag = plans.allgather_plan(p=p)
    rag = ref_plans.allgather_plan(p=p, executor="sim")
    np.testing.assert_array_equal(ag.run(red).numpy(), np.asarray(rag.run(jnp.asarray(red.numpy()))))
    ar = plans.allreduce_plan(p=p, transform=transform)
    rar = ref_plans.allreduce_plan(p=p, executor="sim", transform=transform)
    np.testing.assert_array_equal(ar.run(torch.from_numpy(x)).numpy(),
                                  np.asarray(rar.run(jnp.asarray(x))))
    if transform == "identity":  # the halving's owners hold the reduced segments
        full = x.sum(0).reshape(p0, -1)
        for r in range(p0):
            np.testing.assert_allclose(red[r].numpy(), full[r], atol=1e-5)


@pytest.mark.parametrize("transform", ["identity", "int8"])
@pytest.mark.parametrize("p", [2, 3, 5, 6])
def test_run_buffers_is_run_per_buffer(p, transform):
    """Stage-major execution across buffers changes no bit of any buffer."""
    p0 = schedules.pivot(p)[0]
    xs = [_stacked(p, p0 * 256 * k, 10 * p + k) for k in (1, 3, 2)]
    for plan in (plans.reduce_scatter_plan(p=p, transform=transform),
                 plans.allreduce_plan(p=p, transform=transform), plans.allgather_plan(p=p)):
        bufs = [torch.from_numpy(x) for x in xs]
        out = plan.run_buffers(bufs)
        assert bufs == []  # the list is consumed
        for x, o in zip(xs, out):
            assert torch.equal(o, plan.run(torch.from_numpy(x)))
    with pytest.raises(ValueError):
        plans.reduce_scatter_plan(p=p, transform="int8").run_buffers(
            [torch.zeros((p, p0 * 256 + 256))])


@pytest.mark.parametrize("bucket_bytes", [32 * 2**20, 1 << 15, None])
def test_bucket_layout_of_the_llama_tree_equals_the_reference(bucket_bytes):
    """Same slots, offsets, lengths and bucket order as the reference's
    layout of its own param tree (fp32 view, quantum 512 = p0 2 x 256)."""
    cfg = registry.get_smoke_config("llama3.2-1b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layout = buckets.build_layout(reference_tree(params), bucket_bytes=bucket_bytes,
                                  quantum=512, dtype=torch.float32)
    rcfg = ref_registry.get_smoke_config("llama3.2-1b")
    rshape = jax.eval_shape(lambda: ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    rshape = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, jnp.float32), rshape)
    rlayout = ref_buckets.build_layout(rshape, bucket_bytes=bucket_bytes, quantum=512)

    def desc(lay):
        return [(b.dtype, b.length, [(s.index, s.shape, s.offset, s.size) for s in b.slots])
                for b in lay.buckets]

    assert desc(layout) == desc(rlayout)
    assert len(layout.buckets) == (1 if bucket_bytes is None else
                                   {32 * 2**20: 1, 1 << 15: 8}[bucket_bytes])
    # pack / unpack round trip, in the reference's bytes
    bufs = buckets.pack(reference_tree(params), layout)
    rparams = jax.tree.map(lambda a: jnp.asarray(a.numpy()),
                           reference_tree({k: v if not isinstance(v, dict) else dict(v)
                                           for k, v in params.items()}))
    for b, rb in zip(bufs, ref_buckets.pack(rparams, rlayout)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    back = buckets.unpack(bufs, layout)
    for a, b in zip(buckets.tree_flatten(back)[0], buckets.tree_flatten(reference_tree(params))[0]):
        assert torch.equal(a, b)


def test_full_width_bucket_layout():
    """llama3.2-1b at full width, 32 MiB cap: embed and each stacked matrix
    alone, the two norm stacks together (layout only; nothing allocated)."""
    cfg = registry.get_config("llama3.2-1b")
    shapes = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,),
              "layers": {"wq": (16, 2048, 2048), "wk": (16, 2048, 512), "wv": (16, 2048, 512),
                         "wo": (16, 2048, 2048), "ln1": (16, 2048), "ln2": (16, 2048),
                         "w1": (16, 2048, 8192), "w3": (16, 2048, 8192),
                         "w2": (16, 8192, 2048)}}
    meta = {k: (torch.empty(v, device="meta", dtype=torch.bfloat16) if isinstance(v, tuple)
                else {k2: torch.empty(v2, device="meta", dtype=torch.bfloat16)
                      for k2, v2 in v.items()}) for k, v in shapes.items()}
    layout = buckets.build_layout(reference_tree(meta), bucket_bytes=32 * 2**20, quantum=512,
                                  dtype=torch.float32)
    names = [[layout.treedef[s.index][-1] for s in b.slots] for b in layout.buckets]
    assert names == [["embed"], ["final_norm"], ["wk"], ["wo"], ["wq"], ["wv"], ["ln1", "ln2"],
                     ["w1"], ["w2"], ["w3"]]
    assert max(layout.bucket_lengths) == 16 * 2048 * 8192


def test_ef_roundtrip_in_place_equals_the_functional_form():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((3, 1024)) * 2).astype(np.float32))
    ef = torch.from_numpy((rng.standard_normal((3, 1024)) * 1e-2).astype(np.float32))
    send, new_ef = transforms.ef_roundtrip(x, ef)
    ef_rows = torch.zeros((3, 2048))
    ef_rows[:, 512:1536] = ef  # a strided view, as the EF rows of a bucket are
    view = ef_rows[:, 512:1536]
    send_ = transforms.ef_roundtrip_(x.clone(), view)
    assert torch.equal(send_, send) and torch.equal(view, new_ef)
    assert not ef_rows[:, :512].any() and not ef_rows[:, 1536:].any()
