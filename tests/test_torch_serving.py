"""The port's serving stack against the reference's, end to end.

One module-scoped reference run: the reference ``ServeEngine`` serves six
requests on ``llm_decode_paged`` (smoke llama3.2-1b, fp32, ``attn="gather"``,
dp 3, block size 8, 3 slots so slots recycle, staggered arrivals, two
requests retired by EOS).  The port's engine serves the same requests on
the CPU with the converted weights, over both of its attention paths:
every request's output token ids and its admission and retirement ticks
must be identical.

Also here: the port's block allocator on the example that breaks the
reference's registry, the fcfs scheduler, and the paged pool's block
accounting.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BlockAllocator,
    Request,
    ServeConfig,
    ServeEngine,
    get_scheduler,
    make_workload,
)

DP, SLOTS, BS, MAX_LEN, MAX_PROMPT = 3, 3, 8, 24, 12
ARRIVALS = [0, 0, 1, 3, 5, 8]
PLENS = [3, 9, 5, 12, 1, 7]
MAX_NEW = [6, 4, 9, 5, 7, 3]
EOS_AT = {2: 2, 4: 1}  # request id -> index of its output token used as EOS


def _ref_requests(cfg, eos):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=L).astype(np.int32) for L in PLENS]
    return [RefRequest(id=i, arrival=ARRIVALS[i], prompt=prompts[i], max_new=MAX_NEW[i],
                       eos=eos.get(i, -1)) for i in range(len(PLENS))]


@pytest.fixture(scope="module")
def reference():
    """The reference run (its first pass picks EOS ids the requests really
    emit, so EOS retirement is exercised)."""
    rcfg = ref_registry.get_smoke_config("llama3.2-1b")
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))
    wl = ref_make_workload("llm_decode_paged", cfg=rcfg, mesh=mesh, slots=SLOTS,
                           max_len=MAX_LEN, max_prompt_len=MAX_PROMPT, seed=0,
                           block_size=BS, attn="gather")
    first = RefServeEngine(wl, RefServeConfig(dp=DP)).run(_ref_requests(rcfg, {}))
    eos = {i: int(first[i].output[k]) for i, k in EOS_AT.items()}
    wl.reset()
    reqs = _ref_requests(rcfg, eos)
    res = RefServeEngine(wl, RefServeConfig(dp=DP)).run(reqs)
    for i, k in EOS_AT.items():
        assert res[i].n_tokens <= k + 1  # retired by EOS, not by budget
    return reqs, res, jax.tree.map(np.asarray, wl.params)


def _port_run(reference, attn):
    reqs, _, np_params = reference
    cfg = registry.get_smoke_config("llama3.2-1b")
    wl = make_workload("llm_decode_paged", cfg=cfg, slots=SLOTS, max_len=MAX_LEN,
                       max_prompt_len=MAX_PROMPT, device="cpu", block_size=BS, attn=attn,
                       params=params_from_reference(np_params, cfg, device="cpu"))
    ours = [Request(id=r.id, arrival=r.arrival, prompt=r.prompt, max_new=r.max_new, eos=r.eos)
            for r in reqs]
    eng = ServeEngine(wl, ServeConfig(dp=DP))
    return wl, eng, eng.run(ours)


@pytest.mark.parametrize("attn", ["kernel", "gather"])
def test_tokens_and_ticks_match_reference_engine(reference, attn):
    _, ref_res, _ = reference
    wl, eng, res = _port_run(reference, attn)
    assert sorted(res) == sorted(ref_res)
    for i, r in ref_res.items():
        np.testing.assert_array_equal(res[i].output, r.output)
        assert (res[i].admit_tick, res[i].retire_tick) == (r.admit_tick, r.retire_tick)
        assert res[i].n_tokens == r.n_tokens and res[i].converged == r.converged
    s = eng.summary()
    assert s["completed"] == len(ref_res) and s["decode_ticks"] == s["ticks"]
    assert wl.pool.allocator.used_blocks == 0  # every block came back
    wl.pool.allocator.check()


def test_dp1_retires_sooner_than_dp3(reference):
    """dp 1 has a zero-stage plan (every tick certifies); dp 3 waits for a
    3-stage MRD cycle, so no request retires earlier at dp 3."""
    reqs, ref_res, np_params = reference
    cfg = registry.get_smoke_config("llama3.2-1b")
    wl = make_workload("llm_decode_paged", cfg=cfg, slots=SLOTS, max_len=MAX_LEN,
                       max_prompt_len=MAX_PROMPT, device="cpu", block_size=BS,
                       params=params_from_reference(np_params, cfg, device="cpu"))
    ours = [Request(id=r.id, arrival=r.arrival, prompt=r.prompt, max_new=r.max_new, eos=r.eos)
            for r in reqs]
    res = ServeEngine(wl, ServeConfig(dp=1)).run(ours)
    assert all(res[i].retire_tick - res[i].admit_tick
               <= ref_res[i].retire_tick - ref_res[i].admit_tick for i in res)
    for i in res:  # tokens are a prefix-stable function of the request alone
        n = min(res[i].n_tokens, ref_res[i].n_tokens)
        np.testing.assert_array_equal(res[i].output[:n], ref_res[i].output[:n])


# ---------------------------------------------------------------------------
# Block allocator
# ---------------------------------------------------------------------------


def _drive_allocator(ops, num_blocks):
    """The reference's model test (``tests/test_paged_allocator.py``) as a
    plain function: arbitrary alloc/release/retain/register/fork ops
    against a refcount model, invariants checked after every op."""
    a = BlockAllocator(num_blocks, 8)
    held = []
    for code, x, y in ops:
        if code == 0:
            if a.free_blocks:
                b = a.alloc()
                assert b != 0 and b not in held
                held.append(b)
            else:
                with pytest.raises(MemoryError):
                    a.alloc()
        elif code == 1 and held:
            b = held.pop(x % len(held))
            assert a.release(b) == (b not in held)
        elif code == 2 and held:
            b = held[x % len(held)]
            a.retain(b)
            held.append(b)
        elif code == 3 and held:
            b = held[x % len(held)]
            key = bytes([y])
            owner = a.peek(key)
            if owner is None:
                a.register(key, b)
                owner = b
            assert a.lookup(key) == owner
            held.append(owner)
        elif code == 4 and held:
            b = held[x % len(held)]
            if held.count(b) == 1:
                assert a.fork_private(b) == (b, False)
            elif a.free_blocks:
                others = held.count(b) - 1
                held.remove(b)
                nb, copied = a.fork_private(b)
                assert copied and nb != b and nb not in held
                assert a.ref[b] == others
                held.append(nb)
            else:
                with pytest.raises(MemoryError):
                    a.fork_private(b)
        counts = np.bincount(held, minlength=num_blocks) if held else np.zeros(num_blocks)
        assert (a.ref[1:] == counts[1:]).all()
        a.check()
    for b in list(held):
        held.remove(b)
        a.release(b)
    assert a.free_blocks == num_blocks - 1
    assert not a._block_of and not a._keys_of
    a.check()


def test_allocator_registry_stays_symmetric_on_reference_counterexample():
    """Two keys registered on one block: the reference overwrote the first
    key's back-pointer and failed its own check here."""
    _drive_allocator([(0, 0, 0), (3, 0, 0), (3, 0, 1)], num_blocks=2)


@pytest.mark.parametrize("seed", range(8))
def test_allocator_random_op_sequences(seed):
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, 5)), int(rng.integers(0, 1 << 30)), int(rng.integers(0, 8)))
           for _ in range(80)]
    _drive_allocator(ops, num_blocks=int(rng.integers(2, 13)))


def test_allocator_refuses_trash_and_unallocated_blocks():
    a = BlockAllocator(4, 8)
    for fn in (a.release, a.retain):
        with pytest.raises(ValueError):
            fn(0)
        with pytest.raises(ValueError):
            fn(2)
    with pytest.raises(ValueError):
        a.register(b"k", 0)
    assert [a.alloc() for _ in range(3)] == [1, 2, 3]
    with pytest.raises(MemoryError):
        a.alloc()


# ---------------------------------------------------------------------------
# Scheduler and pool accounting
# ---------------------------------------------------------------------------


def test_fcfs_orders_by_arrival_then_id():
    reqs = [Request(id=i, arrival=a) for i, a in enumerate([3, 1, 1, 0])]
    sched = get_scheduler("fcfs")
    assert [r.id for r in sched.order(reqs, now=5)] == [3, 1, 2, 0]
    with pytest.raises(ValueError):
        get_scheduler("nope")


def test_prefix_sharing_and_backpressure_on_cpu():
    """Shared system prompts map to one physical block; a request that
    does not fit waits in the queue instead of failing, and every block
    returns to the allocator."""
    cfg = registry.get_smoke_config("llama3.2-1b")
    wl = make_workload("llm_decode_paged", cfg=cfg, slots=3, max_len=24, max_prompt_len=16,
                       device="cpu", block_size=8, num_blocks=6)
    rng = np.random.default_rng(1)
    sys_prompt = rng.integers(0, cfg.vocab, size=8)
    reqs = [Request(id=i, prompt=np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, 3)]),
                    max_new=10) for i in range(4)]
    eng = ServeEngine(wl, ServeConfig(dp=3))
    res = eng.run(reqs)
    assert sorted(res) == [0, 1, 2, 3]
    assert all(r.n_tokens == 10 for r in res.values())
    assert wl.prefix_saved_blocks >= 1
    assert wl.pool.allocator.used_blocks == 0
    wl.pool.allocator.check()


def test_cli_queues_the_reference_clis_requests(monkeypatch):
    """At the same seed the port's CLI queues the prompts, budgets and
    arrivals the reference CLI queues (the reference's engine is stubbed
    out once it has the requests)."""
    from repro.launch import serve as ref_cli
    from repro_torch.launch import serve as cli

    class _Captured(Exception):
        pass

    class _Engine:
        def __init__(self, workload, cfg):
            pass

        def run(self, reqs):
            raise _Captured(reqs)

    monkeypatch.setattr(ref_cli, "make_workload", lambda *a, **k: None)
    monkeypatch.setattr(ref_cli, "ServeEngine", _Engine)
    with pytest.raises(_Captured) as got:
        ref_cli.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "--workload",
                      "llm_decode_paged", "--requests", "5", "--prompt-len", "9",
                      "--gen", "7", "--seed", "3"])
    ref_reqs = got.value.args[0]
    ours = cli.make_requests(registry.get_smoke_config("llama3.2-1b"), 5, 9, 7, seed=3)
    assert len(ours) == len(ref_reqs) == 5
    for a, b in zip(ours, ref_reqs):
        assert (a.id, a.arrival, a.max_new, a.eos) == (b.id, b.arrival, b.max_new, b.eos)
        np.testing.assert_array_equal(a.prompt, b.prompt)
