"""Elastic serving in the port against the reference, on the CPU: the
grow's state transfer and the LLM pools under kill/join chaos.

- ``mrd_broadcast_stacked`` at p 1, 2, 3, 5, 6 and 7 (assorted ``src`` and
  ``dst``, in one piece and in pieces smaller than the leaves) over bf16,
  fp32, int32, bool and zero-size leaves: every result equals the source
  (``torch.equal``) and the reference's output.
- The reference chaos suite's traffic and script (4 -> 3 -> 5 -> 4 under
  Poisson arrivals, a stall riding along) at ``steps_per_dispatch`` 3 on
  the smoke llama3.2-1b in fp32 with converted weights, on the contiguous
  and the paged pool: the resize events (kind, tick, extents, keep map,
  reason), every request's tokens and admission and retirement ticks,
  ``prefills`` and the ``summary()`` integers equal the reference's; the
  chaotic run equals the port's own uninterrupted dp-4 run bit for bit;
  the allocator ends empty and consistent.
- A grow installs the joiner's copy of everything the next tick reads:
  with the source's storage scribbled over right after the broadcast (the
  pool's host state too), the run's tokens are unchanged.
- The paged pool's host export round trip keeps a block's several prefix
  keys (the reference keeps one a block); ``resize`` refuses a bad keep
  map and takes the identity as a no-op.

The reference is recorded once for the module.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_chaos as tc  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed.serve import mrd_broadcast_stacked as ref_broadcast  # noqa: E402
from repro.runtime import ElasticServeController as RefController  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve as dserve  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.runtime import ElasticServeController  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BlockAllocator,
    Request,
    ServeConfig,
    ServeEngine,
    make_workload,
)

ARCH, SLOTS, MAX_LEN, MAX_PROMPT, DP, SPD = "llama3.2-1b", 2, 24, 12, 4, 3
WORKLOADS = ("llm_decode", "llm_decode_paged")
SUMMARY_INTS = ("completed", "ticks", "tokens_out", "sla_total", "sla_met", "goodput_ok",
                "replica_ticks", "converged", "forced_at_capacity", "retried", "resizes")
# (p, src, dst) of the broadcast cases
BCAST = [(1, 0, 0), (2, 1, 0), (3, 0, 2), (5, 2, 4), (6, 5, 1), (7, 3, 6)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The stacked MRD broadcast
# ---------------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(17)
    return {
        "bf16": rng.standard_normal((9, 7)).astype(np.float32),  # rounded to bf16 below
        "f32": {"w": (rng.standard_normal((7, 5)) * 1e3).astype(np.float32),
                "neg_zero": np.array([-0.0, 1.5, -2.25], np.float32)},
        "i32": rng.integers(-(2**30), 2**30, size=(11,)).astype(np.int32),
        "flags": rng.random((6,)) < 0.5,
        "empty": np.zeros((0, 4), np.float32),
    }


def _as_torch(tree):
    out = {k: (_as_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()))
           for k, v in tree.items()}
    if "bf16" in out:
        out["bf16"] = out["bf16"].to(torch.bfloat16)
    return out


def _as_ref(tree):
    out = {k: (_as_ref(v) if isinstance(v, dict) else jnp.asarray(v)) for k, v in tree.items()}
    if "bf16" in out:
        out["bf16"] = out["bf16"].astype(jnp.bfloat16)
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def ref_broadcasts():
    tree = _as_ref(_tree())
    return {case: dict(_flat(jax.tree.map(np.asarray, ref_broadcast(tree, case[0], src=case[1],
                                                                   dst=case[2]))))
            for case in BCAST}


@pytest.mark.parametrize("chunk", [dserve.BROADCAST_CHUNK, 5])
@pytest.mark.parametrize("case", BCAST, ids=lambda c: "p%d-src%d-dst%d" % c)
def test_broadcast_equals_the_source_and_the_reference(monkeypatch, case, chunk,
                                                       ref_broadcasts):
    p, src, dst = case
    monkeypatch.setattr(dserve, "BROADCAST_CHUNK", chunk)
    src_tree = _as_torch(_tree())
    want = {name: leaf.clone() for name, leaf in _flat(src_tree)}
    ptrs = {name: leaf.data_ptr() for name, leaf in _flat(src_tree)}
    out = dserve.mrd_broadcast_stacked(src_tree, p, src=src, dst=dst)
    ref = ref_broadcasts[case]
    for name, got in _flat(out):
        assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
        assert torch.equal(got, want[name]), (case, name)
        bf16 = got.dtype == torch.bfloat16
        g = got.float().numpy() if bf16 else got.numpy()
        r = np.asarray(ref[name]).astype(np.float32) if bf16 else np.asarray(ref[name])
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
        if got.numel():
            assert got.data_ptr() == ptrs[name], name  # written into the leaf's own storage


def test_broadcast_in_place_keeps_each_leafs_storage_and_carries_host_scalars(monkeypatch):
    tree = {"t": torch.arange(10, dtype=torch.float32).reshape(2, 5),
            "a": np.arange(6, dtype=np.int64), "stage": 3, "flag": True, "none": None,
            "seq": [torch.ones(3, dtype=torch.bool)],
            "view": torch.arange(12.0).reshape(3, 4).t()}  # not contiguous: a new tensor
    ptr, arr = tree["t"].data_ptr(), tree["a"]
    monkeypatch.setattr(dserve, "BROADCAST_CHUNK", 4)
    out = dserve.mrd_broadcast_stacked(tree, 5, src=0)
    assert out["t"].data_ptr() == ptr and out["a"] is arr
    assert torch.equal(out["t"], torch.arange(10, dtype=torch.float32).reshape(2, 5))
    assert (out["stage"], out["flag"], out["none"]) == (3, True, None)
    assert type(out["stage"]) is int and type(out["flag"]) is bool
    assert isinstance(out["seq"], list) and torch.equal(out["seq"][0], torch.ones(3).bool())
    assert torch.equal(out["view"], torch.arange(12.0).reshape(3, 4).t())
    with pytest.raises(ValueError, match="ranks"):
        dserve.mrd_broadcast_stacked(tree, 3, src=3)


# ---------------------------------------------------------------------------
# LLM pools under chaos against the reference
# ---------------------------------------------------------------------------


def _pool_kw(workload):
    return {"block_size": 8} if workload == "llm_decode_paged" else {}


def _mesh():
    return compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))


@functools.lru_cache(maxsize=None)
def _reference(workload):
    rcfg = ref_registry.get_smoke_config(ARCH)
    wl = ref_make_workload(workload, cfg=rcfg, mesh=_mesh(), slots=SLOTS, max_len=MAX_LEN,
                           max_prompt_len=MAX_PROMPT, seed=0, **_pool_kw(workload))
    eng = RefServeEngine(wl, RefServeConfig(dp=DP, steps_per_dispatch=SPD))
    ctl = RefController(eng, policy="grow_on_join")
    script = tc.script()
    res = ctl.run(tc.llm_requests(RefRequest, rcfg.vocab), events=script)
    assert len(script.fired) == 5
    return {"events": [(e.kind, e.step, e.old_dp, e.new_dp, e.keep, e.reason)
                       for e in ctl.resizes],
            "results": {i: (np.asarray(r.output), r.arrival, r.admit_tick, r.retire_tick,
                            r.n_tokens) for i, r in res.items()},
            "prefills": wl.prefills, "summary": eng.summary(),
            "params": jax.tree.map(np.asarray, wl.params)}


def _workload(workload):
    cfg = registry.get_smoke_config(ARCH)
    params = params_from_reference(_reference(workload)["params"], cfg, device="cpu")
    return make_workload(workload, cfg=cfg, slots=SLOTS, max_len=MAX_LEN,
                         max_prompt_len=MAX_PROMPT, device="cpu", params=params,
                         **_pool_kw(workload))


def _chaos_run(wl):
    eng = ServeEngine(wl, ServeConfig(dp=DP, steps_per_dispatch=SPD))
    ctl = ElasticServeController(eng, policy="grow_on_join")
    script = tc.script()
    res = ctl.run(tc.llm_requests(Request, wl.cfg.vocab), events=script)
    assert len(script.fired) == 5, "the chaos script did not fully fire"
    return eng, ctl, res


def _results(res):
    return {i: (np.asarray(r.output), r.arrival, r.admit_tick, r.retire_tick, r.n_tokens)
            for i, r in res.items()}


def _assert_same(res, want):
    assert sorted(res) == sorted(want)
    for i, w in want.items():
        np.testing.assert_array_equal(res[i][0], w[0], err_msg=f"request {i}")
        assert res[i][1:] == w[1:], (i, res[i][1:], w[1:])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_chaos_run_matches_the_reference(workload):
    ref = _reference(workload)
    wl = _workload(workload)
    eng, ctl, res = _chaos_run(wl)
    assert [(e.kind, e.step, e.old_dp, e.new_dp, e.keep, e.reason)
            for e in ctl.resizes] == ref["events"]
    assert tc.trajectory(ctl.resizes) == tc.TRAJECTORY and eng.dp == DP
    _assert_same(_results(res), ref["results"])
    assert wl.prefills == ref["prefills"] == len(res), "a resize prefilled a slot again"
    s = eng.summary()
    assert {k: s[k] for k in SUMMARY_INTS} == {k: ref["summary"][k] for k in SUMMARY_INTS}
    assert s["resizes"] == 3
    if workload == "llm_decode_paged":
        assert wl.pool.allocator.used_blocks == 0
        wl.pool.allocator.check()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_chaos_run_equals_the_uninterrupted_run(workload):
    wl = _workload(workload)
    steady = _results(ServeEngine(wl, ServeConfig(dp=DP)).run(
        tc.llm_requests(Request, wl.cfg.vocab)))
    wl.reset()
    _, ctl, res = _chaos_run(wl)
    assert tc.trajectory(ctl.resizes) == tc.TRAJECTORY
    for i, (toks, *_) in steady.items():
        np.testing.assert_array_equal(np.asarray(res[i].output), toks, err_msg=f"request {i}")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_grow_installs_the_joiners_copy_of_what_the_next_tick_reads(monkeypatch, workload):
    """The broadcast runs on a copy of the source's tree and the source's
    storage is scribbled over at once, as a joiner has none of it: the
    tokens and ticks still equal the reference's, so the copy carried
    everything."""
    real = dserve.mrd_broadcast_stacked
    grows = []

    def scribble(x):
        if isinstance(x, torch.Tensor) and x.numel() and x.is_contiguous():
            x.fill_(True) if x.dtype == torch.bool else x.reshape(-1).view(torch.uint8).fill_(0xA5)
        elif isinstance(x, np.ndarray) and x.size and x.flags.writeable:
            x.fill(True) if x.dtype == bool else x.reshape(-1).view(np.uint8).fill(0xA5)

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return x.copy() if isinstance(x, np.ndarray) else x

    def joiner_only(tree, p, src=0, dst=None):
        out = real(dserve._map_tree(clone, tree), p, src=src, dst=dst)
        dserve._map_tree(scribble, tree)
        if "host" in tree:  # the pool's own host state is the source's too
            pool = wl.pool
            pool.lengths[:] = 7
            pool.slot_cap[:] = 1
            pool.slot_blocks = [[] for _ in range(pool.slots)]
            pool.allocator = BlockAllocator(pool.num_blocks, pool.block_size)
        grows.append(sorted(tree))
        return out

    monkeypatch.setattr(dserve, "mrd_broadcast_stacked", joiner_only)
    wl = _workload(workload)
    eng, ctl, res = _chaos_run(wl)
    want = ["ctrl", "params", "tstate", "wstate"] + (["host"] if workload.endswith("paged")
                                                     else [])
    assert grows == [sorted(want)]
    _assert_same(_results(res), _reference(workload)["results"])
    if workload == "llm_decode_paged":
        assert wl.pool.allocator.used_blocks == 0
        wl.pool.allocator.check()


# ---------------------------------------------------------------------------
# The paged pool's host export, resize's keep-map checks
# ---------------------------------------------------------------------------


def test_paged_export_round_trip_keeps_every_key_of_a_block():
    a = BlockAllocator(8, 4)
    b1, b2 = a.alloc(), a.alloc()
    a.register(b"prefix-one", b1)
    a.register(b"prefix-two", b1)  # a second key on the same block
    a.register(b"other", b2)
    a.retain(b1)
    a.release(b2)  # freed: its key goes with it
    arrays = a.export_arrays()
    assert {k: v.dtype for k, v in arrays.items()} == {
        "ref": np.int32, "free": np.int32, "key_bytes": np.uint8, "key_lens": np.int32,
        "key_blocks": np.int32}
    back = BlockAllocator.from_arrays(arrays, 8, 4)
    back.check()
    assert back.peek(b"prefix-one") == back.peek(b"prefix-two") == b1
    assert back.peek(b"other") is None
    assert back._free == a._free and np.array_equal(back.ref, a.ref)
    # the free list's pop order survived
    assert BlockAllocator.from_arrays(arrays, 8, 4).alloc() == a.alloc()
    # the rebuilt block keeps both keys: its last release drops both
    back.release(b1)
    back.release(b1)
    back.check()
    assert back.peek(b"prefix-one") is None and back.peek(b"prefix-two") is None


def test_paged_pool_export_import_restores_the_host_state():
    cfg = registry.get_smoke_config(ARCH)
    kw = dict(cfg=cfg, slots=3, max_len=24, max_prompt_len=12, device="cpu", block_size=4)
    wl = make_workload("llm_decode_paged", **kw)
    rng = np.random.default_rng(4)
    sys_prompt = rng.integers(0, cfg.vocab, size=8)
    for slot in range(2):
        req = Request(id=slot, prompt=np.concatenate([sys_prompt, [slot + 1]]), max_new=5)
        wl.admit(req, slot, 0)
    st = wl.export_state()
    other = make_workload("llm_decode_paged", params=wl.params, **kw)
    other.import_state(dserve.mrd_broadcast_stacked(st, 3, src=0))
    other.pool.allocator.check()
    assert other.pool.slot_blocks == wl.pool.slot_blocks
    assert other.pool.prefix_saved_blocks == wl.pool.prefix_saved_blocks == 2
    assert np.array_equal(other.pool.lengths, wl.pool.lengths)
    assert np.array_equal(other.pool.slot_cap, wl.pool.slot_cap)
    assert other.pool.allocator.export_arrays().keys() == st["allocator"].keys()
    for k, v in st["allocator"].items():
        assert np.array_equal(other.pool.allocator.export_arrays()[k], v), k


def test_resize_refuses_a_bad_keep_map_and_skips_the_identity():
    wl = make_workload("fixedpoint_solve", solver="d_iteration", n=12, dp=2, slots=2,
                       damping=0.5, device="cpu")
    eng = ServeEngine(wl, ServeConfig(termination="residual_inexact", dp=2))
    with pytest.raises(ValueError, match="keep"):
        eng.resize(3, (0, 1))  # the keep map does not cover new_dp
    with pytest.raises(ValueError, match="outside"):
        eng.resize(2, (0, 5))
    assert eng.resize(2, (0, 1)) is None
    assert eng.resizes == [] and eng.summary()["resizes"] == 0
    with pytest.raises(ValueError, match="divide"):
        eng.resize(5, (0, 1, None, None, None))  # n = 12 has no 5 blocks
    # a workload built at another extent is aligned, not refused
    other = ServeEngine(wl, ServeConfig(termination="residual_inexact", dp=3))
    assert other.dp == wl.dp == wl.pool.dp == 3
