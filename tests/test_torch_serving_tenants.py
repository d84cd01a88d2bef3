"""The port's traffic model (``repro_torch.serving.tenants``) against the
reference's, and the reference's tenant tests run on the port.

Equal, not close: the module is numpy-seeded in both packages, so arrival
ticks (every kind at 3 seeds), parsed tenant tables and the request
streams ``build_requests`` draws for an LLM and a fixed-point tenant mix
must be the reference's exactly.  Then the non-autoscale cases of
``tests/test_tenants_scale.py`` (arrival generators, tenant specs, request
materialization, quota-aware admission, the ``sla_edf`` promotion bound,
the NaN percentile rules, tick-domain SLA, per-tenant summaries,
``TenantScenario``) on the port's fixed-point workload on the CPU.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.serving import build_requests as ref_build_requests  # noqa: E402
from repro.serving import make_arrival_ticks as ref_arrival_ticks  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro.serving import parse_tenant_specs as ref_parse  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ARRIVALS,
    Request,
    ServeConfig,
    ServeEngine,
    TenantScenario,
    TenantSpec,
    build_requests,
    make_arrival_ticks,
    make_workload,
    parse_tenant_specs,
    quotas_of,
)

FP = "fixedpoint_solve"
SPECS = ("none", "poisson:0.5", "poisson:2.0", "bursty:0.2,2.0", "bursty:0.05,5.0,0.05,20",
         "diurnal:1.0,40", "diurnal:2.0,100,0.01")


def fp_workload(slots=4, dp=1, n=16, **kw):
    return make_workload(FP, solver="d_iteration", n=n, dp=dp, slots=slots, damping=0.6,
                         device="cpu", **kw)


def _mesh():
    return compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))


# ---------------------------------------------------------------------------
# equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("spec", SPECS)
def test_arrival_ticks_equal_reference(spec, seed):
    assert make_arrival_ticks(spec, 40, seed) == ref_arrival_ticks(spec, 40, seed)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_trace_arrivals_equal_reference(tmp_path, seed):
    f = tmp_path / "trace.json"
    f.write_text(json.dumps(np.random.default_rng(seed).integers(0, 50, 12).tolist()))
    assert make_arrival_ticks(f"trace:{f}", 12, seed) == ref_arrival_ticks(f"trace:{f}", 12,
                                                                             seed)


def test_parse_tenant_specs_equals_reference():
    spec = ("chat:3:sla=8:prio=2:prompt=512:gen=32,batch:1:quota=4:prompt=2048:gen=64,"
            f"solve:2:sla=50:workload={FP}:gen=500:eps=1e-5,bulk:quota=2")
    ours, theirs = parse_tenant_specs(spec), ref_parse(spec)
    assert [dataclasses.asdict(t) for t in ours] == [dataclasses.asdict(t) for t in theirs]
    assert quotas_of(ours) == {"batch": 4, "bulk": 2}


def _fields(r):
    prompt = None if r.prompt is None else np.asarray(r.prompt).tolist()
    payload = None if r.payload is None else np.asarray(r.payload).tolist()
    return (r.id, r.arrival, r.tenant, prompt, payload, r.max_new, r.eos, r.priority, r.sla,
            r.eps)


@pytest.mark.parametrize("workload", ["llm_decode_paged", FP])
def test_build_requests_equals_reference(workload):
    if workload == FP:
        spec = f"solve:2:sla=50:workload={FP}:gen=500:eps=1e-5,bulk:1:workload={FP}:gen=400"
        ours_wl = fp_workload(n=24)
        theirs_wl = ref_make_workload(FP, solver="d_iteration", n=24, dp=1, slots=4,
                                      damping=0.6)
    else:
        spec = "chat:3:sla=8:prio=2:prompt=12:gen=8,batch:1:quota=2:prompt=40:gen=30"
        ours_wl = make_workload(workload, cfg=registry.get_smoke_config("llama3.2-1b"),
                                slots=4, max_len=48, max_prompt_len=20, block_size=8,
                                device="cpu")
        theirs_wl = ref_make_workload(workload,
                                      cfg=ref_registry.get_smoke_config("llama3.2-1b"),
                                      mesh=_mesh(), slots=4, max_len=48, max_prompt_len=20,
                                      block_size=8)
    tenants = tuple(dataclasses.replace(t, workload=workload) for t in parse_tenant_specs(spec))
    ours = build_requests(tenants, {workload: ours_wl}, 30, "bursty:0.2,2.0", seed=5)[workload]
    theirs = ref_build_requests(tuple(dataclasses.replace(t, workload=workload)
                                      for t in ref_parse(spec)),
                                {workload: theirs_wl}, 30, "bursty:0.2,2.0", seed=5)[workload]
    assert [_fields(r) for r in ours] == [_fields(r) for r in theirs]
    assert len({r.tenant for r in ours}) == 2


# ---------------------------------------------------------------------------
# the reference's tenant tests (non-autoscale), on the port
# ---------------------------------------------------------------------------


def test_arrival_registry_floor():
    assert {"none", "poisson", "bursty", "diurnal", "trace"} <= set(ARRIVALS)


def test_arrivals_are_seeded_sorted_and_sized():
    for spec in ("none", "poisson:0.5", "bursty:0.2,2.0", "bursty:0.2,2.0,0.1,10",
                 "diurnal:1.0,40", "diurnal:1.0,40,0.2"):
        a = make_arrival_ticks(spec, 30, seed=3)
        b = make_arrival_ticks(spec, 30, seed=3)
        assert a == b and len(a) == 30 and a == sorted(a)
        assert all(isinstance(t, int) and t >= 0 for t in a)
    assert make_arrival_ticks("poisson:0.5", 30, 3) != make_arrival_ticks("poisson:0.5", 30, 4)


def test_bursty_concentrates_arrivals_vs_base_rate():
    ticks = make_arrival_ticks("bursty:0.05,5.0,0.05,20", 60, seed=1)
    assert len(set(ticks)) < len(ticks) / 2


def test_diurnal_peaks_mid_period():
    ticks = make_arrival_ticks("diurnal:2.0,100,0.01", 100, seed=0)
    phase = [t % 100 for t in ticks]
    assert sum(1 for p in phase if p < 25) < sum(1 for p in phase if 25 <= p < 75)


def test_trace_arrivals_replay_file(tmp_path):
    f = tmp_path / "trace.json"
    f.write_text(json.dumps({"arrivals": [5, 1, 9, 9]}))
    assert make_arrival_ticks(f"trace:{f}", 4, 0) == [1, 5, 9, 9]
    with pytest.raises(ValueError, match="need 9"):
        make_arrival_ticks(f"trace:{f}", 9, 0)


def test_unknown_arrival_kind_raises():
    with pytest.raises(ValueError, match="unknown arrival"):
        make_arrival_ticks("pareto:1.0", 4, 0)


def test_too_low_rate_raises_not_hangs():
    with pytest.raises(ValueError, match="rate too low"):
        make_arrival_ticks("diurnal:0.0,10,0.0", 5, 0)


def test_parse_tenant_specs():
    chat, batch = parse_tenant_specs(
        "chat:3:sla=8:prio=2:gen=12,batch:quota=4:workload=fixedpoint_solve")
    assert chat == TenantSpec("chat", weight=3.0, sla=8, priority=2, max_new=12)
    assert batch.weight == 1.0 and batch.quota == 4 and batch.workload == FP
    assert batch.sla is None
    assert quotas_of((chat, batch)) == {"batch": 4}


@pytest.mark.parametrize("bad", ["chat:1:deadline=3", "a:1,a:2", ""])
def test_parse_tenant_specs_rejects(bad):
    with pytest.raises(ValueError):
        parse_tenant_specs(bad)


def test_build_requests_routes_by_workload_with_unique_ids():
    wl = fp_workload()
    tenants = parse_tenant_specs(f"solve:2:sla=50:workload={FP}:gen=500,bulk:1:workload={FP}:gen=500")
    reqs = build_requests(tenants, {FP: wl}, 20, "poisson:1.0", seed=5)[FP]
    assert len(reqs) == 20
    assert sorted(r.id for r in reqs) == list(range(20))
    assert {r.tenant for r in reqs} == {"solve", "bulk"}
    for r in reqs:
        assert r.payload is not None and r.payload.shape == (16,)
        assert (r.sla == 50) == (r.tenant == "solve")
    again = build_requests(tenants, {FP: wl}, 20, "poisson:1.0", seed=5)[FP]
    assert [(r.tenant, r.arrival) for r in reqs] == [(r.tenant, r.arrival) for r in again]


def test_build_requests_rejects_undeployed_workload():
    with pytest.raises(ValueError, match="llm_decode"):
        build_requests((TenantSpec("chat"),), {FP: fp_workload()}, 4, "none", 0)


def test_weights_must_be_positive():
    with pytest.raises(ValueError, match="positive"):
        build_requests((TenantSpec("a", weight=0.0, workload=FP),), {FP: fp_workload()}, 4,
                       "none", 0)


def test_quota_limits_inflight_and_passes_slot_over():
    eng = ServeEngine(fp_workload(slots=4), ServeConfig(
        termination="residual_interval", eps=1e-2, quotas={"bulk": 1}))
    eng.run([Request(id=i, arrival=0, max_new=500, tenant="bulk" if i < 3 else "free")
             for i in range(6)])
    assert len(eng.results) == 6
    bulk = sorted((r for r in eng.results.values() if r.tenant == "bulk"),
                  key=lambda r: r.admit_tick)
    for a, b in zip(bulk, bulk[1:]):  # quota 1: bulk's intervals never overlap
        assert b.admit_tick >= a.retire_tick
    assert all(r.admit_tick == 0 for r in eng.results.values() if r.tenant == "free")


def test_no_request_waits_past_promotion_bound():
    eng = ServeEngine(fp_workload(slots=2), ServeConfig(
        scheduler="sla_edf:8", termination="residual_interval", eps=1e-2))
    reqs = [Request(id=0, arrival=0, max_new=500, tenant="batch")]
    reqs += [Request(id=1 + i, arrival=i // 2, max_new=500, sla=4, tenant="chat")
             for i in range(40)]
    eng.run(reqs)
    batch = eng.results[0]
    assert batch.admit_tick > 0
    solve_ticks = max(r.retire_tick - r.admit_tick for r in eng.results.values())
    assert batch.admit_tick - batch.arrival <= 8 + solve_ticks
    assert [r for r in eng.results.values() if r.tenant == "chat"
            and r.arrival < batch.admit_tick and r.admit_tick > batch.admit_tick]


def test_empty_summary_reports_nan_percentiles():
    s = ServeEngine(fp_workload(), ServeConfig(termination="residual_interval")).summary()
    for k in ("ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p95_ms",
              "tpot_p99_ms"):
        assert math.isnan(s[k]), k
    assert s["completed"] == 0 and s["tenants"] == {}


def test_single_token_completion_tpot_nan_and_excluded():
    eng = ServeEngine(fp_workload(slots=2), ServeConfig(termination="residual_interval",
                                                        eps=1e-2))
    eng.run([Request(id=0, max_new=1), Request(id=1, max_new=500)])
    assert eng.results[0].n_tokens == 1 and math.isnan(eng.results[0].tpot_s)
    s = eng.summary()
    assert math.isfinite(s["tpot_p50_ms"]) and s["tpot_p50_ms"] > 0.0


def test_sla_met_is_tick_domain():
    eng = ServeEngine(fp_workload(slots=1), ServeConfig(termination="residual_interval",
                                                        eps=1e-2))
    eng.run([Request(id=0, max_new=500, sla=0), Request(id=1, max_new=500, sla=0)])
    assert eng.results[0].sla_met is True and eng.results[1].sla_met is False
    s = eng.summary()
    assert s["sla_total"] == 2 and s["sla_met"] == 1 and s["goodput_ok"] == 1


def test_per_tenant_summary_breakdown():
    eng = ServeEngine(fp_workload(slots=4), ServeConfig(termination="residual_interval",
                                                        eps=1e-2))
    eng.run([Request(id=0, max_new=500, sla=50, tenant="chat"),
             Request(id=1, max_new=500, tenant="batch")])
    t = eng.summary()["tenants"]
    assert set(t) == {"chat", "batch"}
    assert t["chat"]["sla_total"] == 1 and t["chat"]["sla_met"] == 1
    assert t["batch"]["sla_total"] == 0 and t["batch"]["goodput_ok"] == 1
    assert math.isfinite(t["chat"]["ttft_p99_ticks"]) and math.isfinite(t["chat"]["ttft_p99_ms"])


def test_tenant_scenario_merges_engines_and_tenants():
    wl_a, wl_b = fp_workload(slots=2), fp_workload(slots=2, n=24)
    tenants = (TenantSpec("alpha", weight=2.0, workload="fp_a", sla=40, max_new=500),
               TenantSpec("beta", weight=1.0, workload="fp_b", max_new=500))
    reqs = build_requests(tenants, {"fp_a": wl_a, "fp_b": wl_b}, 10, "poisson:0.5", seed=2)
    scen = TenantScenario({
        "fp_a": ServeEngine(wl_a, ServeConfig(termination="residual_interval", eps=1e-2)),
        "fp_b": ServeEngine(wl_b, ServeConfig(termination="residual_interval", eps=1e-2)),
    })
    out = scen.run(reqs)
    assert len(out["fp_a"]) + len(out["fp_b"]) == 10
    s = scen.summary()
    assert s["completed"] == 10 and set(s["tenants"]) == {"alpha", "beta"}
    assert s["ticks"] == sum(e["ticks"] for e in s["engines"].values())
    assert s["replica_ticks"] == sum(e["replica_ticks"] for e in s["engines"].values())
    assert math.isfinite(s["ttft_p99_ms"])
    assert s["goodput_ok"] == s["completed"] - s["sla_total"] + s["sla_met"]
