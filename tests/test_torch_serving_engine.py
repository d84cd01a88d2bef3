"""The port's engine knobs against the reference's engine, on the smoke
llama3.2-1b (fp32) with converted weights, on the CPU.

- **Quotas, retries, SLA goodput, dispatches**: twelve requests of two
  tenants (``batch`` at a quota of one slot in flight) arrive at
  ``poisson:0.5`` ticks and are served by ``sla_edf`` on a contiguous pool
  of 3 slots whose budget clamp is defeated, so three of them freeze at
  cache capacity and are requeued once (``max_retries`` 1) before they
  retire unconverged.  At ``steps_per_dispatch`` 1, 4 and 16 every
  ``RequestResult``'s tokens, ticks, retries, ``sla_met`` and tenant, the
  ``summary()`` integers and the clock after every ``step()`` call equal
  the reference's exactly.
- **share_prefixes**: the paged pool with sharing on and off gives the
  reference's tokens and ``prefix_saved_blocks`` (the reference test's
  traffic: five requests over two slots sharing an 8-token prefix).
"""

import functools

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
    Request,
    ServeConfig,
    ServeEngine,
    make_arrival_ticks,
    make_workload,
)

ARCH, SLOTS, MAX_LEN, MAX_PROMPT = "llama3.2-1b", 3, 24, 12
N_REQ = 12
QUOTAS = {"batch": 1}
CAPPED = {2, 6, 9}  # budgets past the cache: frozen at capacity, requeued once
SUMMARY_INTS = ("completed", "ticks", "tokens_out", "sla_total", "sla_met", "goodput_ok",
                "replica_ticks", "converged", "forced_at_capacity", "retried")
TENANT_INTS = ("completed", "tokens_out", "sla_total", "sla_met", "goodput_ok")


def _mesh():
    return compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))


def _requests(cls):
    rng = np.random.default_rng(5)
    arrivals = make_arrival_ticks("poisson:0.5", N_REQ, seed=7)
    reqs = []
    for i in range(N_REQ):
        tenant = "batch" if i % 3 == 0 else "chat"
        plen = int(rng.integers(1, MAX_PROMPT + 1))
        reqs.append(cls(
            id=i, arrival=arrivals[i],
            prompt=rng.integers(0, 256, size=plen).astype(np.int32),
            max_new=500 if i in CAPPED else int(rng.integers(2, 9)),
            priority=int(rng.integers(0, 3)),
            sla=None if tenant == "batch" else int(rng.integers(2, 12)), tenant=tenant))
    return reqs


def _uncapped(wl):
    # defeat the budget clamp: a request past the cache freezes at capacity
    wl.clamp_max_new = lambda req: int(req.max_new)
    return wl


@functools.lru_cache(maxsize=None)
def _reference(spd):
    """The reference's run at ``steps_per_dispatch`` ``spd``: results,
    summary, the clock after each step, and its weights as numpy."""
    wl = _uncapped(ref_make_workload("llm_decode", cfg=ref_registry.get_smoke_config(ARCH),
                                     mesh=_mesh(), slots=SLOTS, max_len=MAX_LEN,
                                     max_prompt_len=MAX_PROMPT, seed=0))
    eng = RefServeEngine(wl, RefServeConfig(scheduler="sla_edf", dp=3, max_retries=1,
                                            steps_per_dispatch=spd, quotas=QUOTAS))
    for r in _requests(RefRequest):
        eng.submit(r)
    clock = []
    while eng.queue or eng.pending or any(eng.slot_req):
        eng.step()
        clock.append(eng.tick)
    return eng.results, eng.summary(), clock, jax.tree.map(np.asarray, wl.params)


@pytest.mark.parametrize("spd", [1, 4, 16])
def test_quotas_retries_sla_and_dispatches_match_reference(spd):
    ref_res, ref_s, ref_clock, np_params = _reference(spd)
    cfg = registry.get_smoke_config(ARCH)
    wl = _uncapped(make_workload("llm_decode", cfg=cfg, slots=SLOTS, max_len=MAX_LEN,
                                 max_prompt_len=MAX_PROMPT, device="cpu",
                                 params=params_from_reference(np_params, cfg, device="cpu")))
    eng = ServeEngine(wl, ServeConfig(scheduler="sla_edf", dp=3, max_retries=1,
                                      steps_per_dispatch=spd, quotas=QUOTAS))
    for r in _requests(Request):
        eng.submit(r)
    clock = []
    while eng.queue or eng.pending or any(r is not None for r in eng.slot_req):
        eng.step()
        clock.append(eng.tick)
    assert clock == ref_clock
    res, s = eng.results, eng.summary()
    assert sorted(res) == sorted(ref_res) == list(range(N_REQ))
    for i, r in ref_res.items():
        ours = res[i]
        np.testing.assert_array_equal(ours.output, r.output)
        assert (ours.arrival, ours.admit_tick, ours.retire_tick, ours.n_tokens, ours.retries,
                ours.sla_met, ours.tenant, ours.converged) == (
            r.arrival, r.admit_tick, r.retire_tick, r.n_tokens, r.retries, r.sla_met,
            r.tenant, r.converged), i
    assert {k: s[k] for k in SUMMARY_INTS} == {k: ref_s[k] for k in SUMMARY_INTS}
    assert s["goodput_per_ktick"] == ref_s["goodput_per_ktick"]
    assert {n: {k: t[k] for k in TENANT_INTS + ("ttft_p99_ticks",)}
            for n, t in s["tenants"].items()} == {
        n: {k: t[k] for k in TENANT_INTS + ("ttft_p99_ticks",)}
        for n, t in ref_s["tenants"].items()}
    # what the traffic was built to exercise
    assert s["retried"] == len(CAPPED) and s["forced_at_capacity"] == 2 * len(CAPPED)
    assert {i for i, r in res.items() if r.retries} == CAPPED
    assert 0 < s["sla_met"] < s["sla_total"]
    batch = sorted((r for r in res.values() if r.tenant == "batch"), key=lambda r: r.admit_tick)
    for a, b in zip(batch, batch[1:]):  # quota 1: never two in flight
        assert b.admit_tick > a.retire_tick


def test_dispatch_length_changes_no_result_but_a_retry_arrival():
    """steps_per_dispatch moves the step boundaries: the three runs serve
    the same tokens at the same admission and retirement ticks.  Only a
    retried request's new arrival moves: the reference (and the port)
    sets it to the first tick of the dispatch that forced it, not to the
    tick it was forced at, so a longer dispatch dates it earlier."""
    runs = [_reference(spd)[0] for spd in (1, 4, 16)]
    for i in range(N_REQ):
        for r in runs[1:]:
            np.testing.assert_array_equal(r[i].output, runs[0][i].output)
            assert (r[i].admit_tick, r[i].retire_tick) == (runs[0][i].admit_tick,
                                                           runs[0][i].retire_tick)
            if i not in CAPPED:
                assert r[i].arrival == runs[0][i].arrival
    assert all(runs[2][i].arrival <= runs[1][i].arrival <= runs[0][i].arrival for i in CAPPED)
    assert any(runs[2][i].arrival < runs[0][i].arrival for i in CAPPED)
    assert len(_reference(16)[2]) < len(_reference(1)[2])


def _prefix_requests(cls, cfg):
    """The reference test's traffic: 5 requests over 2 slots, an 8-token
    shared prefix (one block)."""
    rng = np.random.default_rng(9)
    pre = rng.integers(0, cfg.vocab, size=8)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab, size=n)]).astype(np.int64)
               for n in (1, 2, 4, 3, 2)]
    return [cls(id=i, arrival=[0, 0, 2, 5, 7][i], prompt=prompts[i],
                max_new=[6, 4, 7, 5, 6][i]) for i in range(5)]


@pytest.mark.parametrize("share", [True, False])
def test_share_prefixes_matches_reference(share):
    rcfg = ref_registry.get_smoke_config(ARCH)
    rwl = ref_make_workload("llm_decode_paged", cfg=rcfg, mesh=_mesh(), slots=2, max_len=24,
                            max_prompt_len=12, seed=0, block_size=8, share_prefixes=share)
    ref_res = RefServeEngine(rwl, RefServeConfig()).run(_prefix_requests(RefRequest, rcfg))
    cfg = registry.get_smoke_config(ARCH)
    wl = make_workload("llm_decode_paged", cfg=cfg, slots=2, max_len=24, max_prompt_len=12,
                       block_size=8, share_prefixes=share, device="cpu",
                       params=params_from_reference(jax.tree.map(np.asarray, rwl.params), cfg,
                                                    device="cpu"))
    res = ServeEngine(wl, ServeConfig()).run(_prefix_requests(Request, cfg))
    for i, r in ref_res.items():
        np.testing.assert_array_equal(res[i].output, r.output)
        assert (res[i].admit_tick, res[i].retire_tick) == (r.admit_tick, r.retire_tick)
    assert wl.prefix_saved_blocks == rwl.prefix_saved_blocks
    assert (wl.prefix_saved_blocks > 0) == share
    assert wl.pool.allocator.used_blocks == 0
    wl.pool.allocator.check()
