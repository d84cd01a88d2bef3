"""Continuous-batching serving sweep (port of ``benchmarks/bench_serve.py``):
scheduler x arrival rate against the static-batch baseline, fixed-point
serving against the barrier baseline, and the paged pool against the
contiguous one on shared-system-prompt traffic.

The static baseline serves requests in waves of ``slots``: every wave
decodes until its longest request finishes, and finished requests idle
their slot, the cost continuous batching removes.  Both paths serve the
same mixed-budget traffic and count the same useful tokens.

Rows (CSV on stdout: name,value,derived):

- ``serve_static_baseline``: the wave baseline's tok/s;
- ``serve_llm_<sched>_<arrival>``: the engine's tok/s, TTFT / TPOT p50/p95
  (ms), occupancy, speedup against static, cache bytes;
- ``serve_llm_{contig,paged}_sysprefix``: the paged pool runs twice the
  slots in the contiguous pool's cache blocks (the system prompt's blocks
  stored once, no worst-case reservation a slot), token for token the
  contiguous pool's (``attn="gather"``, the reference pool's default);
- ``serve_llm_elastic_killjoin`` / ``serve_fixedpoint_elastic_killjoin``:
  three times the traffic (or a grid's ``elastic_requests``) at Poisson
  arrivals through an ``ElasticServeController`` that kills two replicas
  and joins two
  (agreement extent 4 -> 3 -> 5 -> 4), against the same traffic served
  uninterrupted at dp 4; the ``*_post_vs_steady`` ratios time the work
  retired after the last resize;
- ``serve_fixedpoint_<sched>``: per-request D-iteration solves (requests/s)
  against the barrier baseline (each wave iterates until its slowest
  request's true residual is below eps).

The rows go to ``--json`` (default ``chiprun_out/bench_serve.json``,
never the repo's ``BENCH_serve.json``).  ``--quick`` shrinks the grid;
``--check`` asserts the reference's gates: every latency percentile finite,
continuous at least 0.7x static at peak arrival, every fixed-point request
converged, the paged pool token for token the contiguous one at >= 1.5x
the concurrency a cache byte and >= 0.8x its tok/s, and under kill/join
no request lost, three resizes, no slot prefilled again and the rate
after the resizes >= 0.8x the steady run's.  Timed runs are the best of
three identical runs.

    python -m repro_torch.benchmarks.bench_serve [--quick] [--check] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.launch.serve import static_serve
from repro_torch.runtime import ElasticServeController
from repro_torch.runtime.chaos import ChaosScript, Join, Kill
from repro_torch.serving import Request, ServeConfig, ServeEngine, make_arrival_ticks, make_workload

# the elastic rows' script: kill 6:2, join 16:(4, 5), kill 26:0 from dp 4
ELASTIC_DP, ELASTIC_SPD = 4, 4
ELASTIC_EVENTS = (Kill(6, 2), Join(16, (4, 5)), Kill(26, 0))
ELASTIC_FP_N = 60  # divisible by every visited extent (3, 4, 5)

QUICK = {"slots": 2, "n_req": 6, "prompt_len": 6, "gen_max": 24, "schedulers": ("fcfs",),
         "arrivals": ("burst",), "fixedpoint": {"n": 48, "dp": 2, "eps": 1e-6},
         "sysprefix": {"sys_len": 24, "user_len": 4, "gen_lo": 6, "gen_hi": 10,
                       "block_size": 8}}
FULL = {**QUICK, "slots": 4, "n_req": 16, "prompt_len": 12, "gen_max": 48,
        "schedulers": ("fcfs", "priority", "sla_edf"), "arrivals": ("0.25", "1.0", "burst"),
        "fixedpoint": {"n": 66, "dp": 3, "eps": 1e-6}}


def traffic(n_req, prompt_len, gen_max, vocab, seed):
    """Mixed-budget traffic: prompts of ``prompt_len``, budgets in
    [gen_max/3, gen_max]."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=prompt_len) for _ in range(n_req)]
    budgets = [int(b) for b in rng.integers(max(2, gen_max // 3), gen_max + 1, size=n_req)]
    return prompts, budgets


def system_traffic(n_req, vocab, seed, *, sys_len=24, user_len=4, gen_lo=6, gen_hi=10):
    """Shared-system-prompt traffic: one ``sys_len``-token prefix and a
    unique ``user_len``-token suffix a request."""
    rng = np.random.default_rng(seed)
    sys_prefix = rng.integers(0, vocab, size=sys_len)
    prompts = [np.concatenate([sys_prefix, rng.integers(0, vocab, size=user_len)])
               for _ in range(n_req)]
    budgets = [int(b) for b in rng.integers(gen_lo, gen_hi + 1, size=n_req)]
    return prompts, budgets


def arrivals(kind, n_req, seed):
    """'burst': every request queued at tick 0; else a Poisson rate."""
    return make_arrival_ticks("none" if kind == "burst" else f"poisson:{kind}", n_req, seed)


def run_static_llm(cfg, params, prompts, budgets, slots, device):
    """Waves of ``slots`` static batches through the CLI's static path (one
    cached prefill, then greedy decode steps to the wave's largest budget);
    the first wave runs once untimed."""
    P = prompts[0].shape[0]

    def one_wave(wave_prompts, wave_budgets):
        batch = np.zeros((slots, P), np.int64)
        for i, p in enumerate(wave_prompts):
            batch[i] = p
        static_serve(cfg, prompt=torch.from_numpy(batch), gen=max(wave_budgets) - 1,
                     device=device, params=params)

    waves = [(prompts[i:i + slots], budgets[i:i + slots]) for i in range(0, len(prompts), slots)]
    one_wave(*waves[0])
    t0 = time.perf_counter()
    for wp, wb in waves:
        one_wave(wp, wb)
    dt = time.perf_counter() - t0
    useful = sum(budgets)
    return {"tok_s": useful / dt, "wall_s": dt, "useful_tokens": useful}


def run_continuous_llm(workload, prompts, budgets, arrivals, scheduler, *, dp=1,
                       steps_per_dispatch=16):
    """The engine over the requests on a reset ``workload`` -> (summary,
    results)."""
    workload.reset()
    eng = ServeEngine(workload, ServeConfig(scheduler=scheduler, termination="eos_maxlen",
                                            dp=dp, steps_per_dispatch=steps_per_dispatch))
    reqs = [Request(id=i, arrival=a, prompt=p, max_new=b)
            for i, (p, b, a) in enumerate(zip(prompts, budgets, arrivals))]
    results = eng.run(reqs)
    return eng.summary(), results


def best_of(run, key, n=3):
    """The fastest of ``n`` identical (warmed, deterministic) runs."""
    best = None
    for _ in range(n):
        r = run()
        if best is None or key(r) > key(best):
            best = r
    return best


def best_of_pairs(run_a, key_a, run_b, key_b, n=3):
    """The fastest of ``n`` runs of each of two deterministic runs, taken in
    turns (a, b, a, b, ...) after a full garbage collection, so that both
    bests sample the host over the same window."""
    best_a = best_b = None
    for _ in range(n):
        gc.collect()
        a = run_a()
        if best_a is None or key_a(a) > key_a(best_a):
            best_a = a
        gc.collect()
        b = run_b()
        if best_b is None or key_b(b) > key_b(best_b):
            best_b = b
    return best_a, best_b


def mem_fields(workload, summary):
    """Cache-memory accounting of an LLM row."""
    cb = workload.cache_bytes
    return {"cache_mib": round(cb / 2**20, 3), "bytes_per_slot": cb // workload.slots,
            "bytes_per_retired_token": round(cb / max(1, summary["tokens_out"]), 1)}


def run_sysprefix(cfg, params, slots, n_req, seed, device, *, sys_len, user_len, gen_lo,
                  gen_hi, block_size, repeats=3):
    """The contiguous pool at ``slots`` and the paged pool at twice the slots
    in the same cache blocks (plus the trash block) on shared-system-prompt
    burst traffic -> (contiguous row, paged row)."""
    p_prompt = sys_len + user_len
    max_len = -(-(p_prompt + gen_hi + 2) // block_size) * block_size
    prompts, budgets = system_traffic(n_req, cfg.vocab, seed, sys_len=sys_len,
                                      user_len=user_len, gen_lo=gen_lo, gen_hi=gen_hi)
    burst, w = [0] * n_req, slots + 1
    common = dict(cfg=cfg, max_len=max_len, max_prompt_len=p_prompt, params=params,
                  device=device)
    wl_contig = make_workload("llm_decode", slots=slots, **common)
    run_continuous_llm(wl_contig, prompts[:w], budgets[:w], [0] * w, "fcfs")  # warm
    sc, res_c = best_of(lambda: run_continuous_llm(wl_contig, prompts, budgets, burst, "fcfs"),
                        lambda t: t[0]["throughput_tok_s"], repeats)
    contig_row = {"name": "serve_llm_contig_sysprefix", "workload": "llm_decode",
                  "slots": slots, "tok_s": round(sc["throughput_tok_s"], 1),
                  "occupancy": round(sc["occupancy"], 3), **mem_fields(wl_contig, sc)}
    num_blocks = slots * (max_len // block_size) + 1
    wl_paged = make_workload("llm_decode_paged", slots=2 * slots, block_size=block_size,
                             num_blocks=num_blocks, attn="gather", **common)
    run_continuous_llm(wl_paged, prompts[:w], budgets[:w], [0] * w, "fcfs")  # warm
    sp, res_p = best_of(lambda: run_continuous_llm(wl_paged, prompts, budgets, burst, "fcfs"),
                        lambda t: t[0]["throughput_tok_s"], repeats)
    pm = mem_fields(wl_paged, sp)
    # the concurrency each pool affords a MiB of cache
    conc = (2 * slots / (pm["cache_mib"] or 1)) / (slots / (contig_row["cache_mib"] or 1))
    paged_row = {
        "name": "serve_llm_paged_sysprefix", "workload": "llm_decode_paged",
        "slots": 2 * slots, "num_blocks": num_blocks, "block_size": block_size,
        "tok_s": round(sp["throughput_tok_s"], 1), "occupancy": round(sp["occupancy"], 3),
        "prefix_saved_blocks": wl_paged.prefix_saved_blocks,
        "forced_at_capacity": sp["forced_at_capacity"],
        "concurrency_per_byte_vs_contig": round(conc, 3),
        "tok_s_vs_contig": round(sp["throughput_tok_s"] / sc["throughput_tok_s"], 3),
        "bit_exact_vs_contig": all(np.array_equal(res_c[i].output, res_p[i].output)
                                   for i in range(n_req)),
        **pm,
    }
    return contig_row, paged_row


def run_fixedpoint(n, dp, slots, n_req, eps, scheduler, seed, device):
    """Residual-certified solves through the engine against the barrier
    baseline (waves of ``slots`` requests iterate until the slowest one's
    true residual is below ``eps``: a free oracle, a generous baseline)."""
    workload = make_workload("fixedpoint_solve", solver="d_iteration", n=n, dp=dp, slots=slots,
                             damping=0.8, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    payloads = []
    for _ in range(n_req):
        v = rng.random(n).astype(np.float32)
        payloads.append(v / v.sum())
    pm = workload.pool.param_map

    def one_wave(vs):
        V = torch.from_numpy(np.stack(vs)).to(device)
        x = torch.zeros_like(V)
        iters = 0
        while True:
            x = pm(x, V)
            iters += 1
            if bool(((pm(x, V) - x).abs().amax(1) < eps).all()) or iters > 5000:
                return iters

    waves = [payloads[i:i + slots] for i in range(0, n_req, slots)]
    one_wave(waves[0])
    t0 = time.perf_counter()
    total_iters = sum(one_wave(w) for w in waves)
    dt_static = time.perf_counter() - t0

    scfg = ServeConfig(scheduler=scheduler, termination="residual_interval", dp=dp, eps=eps)
    ServeEngine(workload, scfg).run(  # warm
        [Request(id=-1 - i, payload=p, max_new=5000) for i, p in enumerate(payloads[:slots + 1])])
    workload.reset()
    eng = ServeEngine(workload, scfg)
    eng.run([Request(id=i, payload=p, max_new=5000) for i, p in enumerate(payloads)])
    s = eng.summary()
    return {"req_s": n_req / s["wall_s"], "static_req_s": n_req / dt_static,
            "ticks": s["ticks"], "static_iters": total_iters, "converged": s["converged"],
            "occupancy": s["occupancy"]}


def _run_elastic(eng, reqs, done_of):
    """The controller loop under the elastic script -> (results, the rate
    of the work retired after the last resize, a second)."""
    ctl = ElasticServeController(eng, policy="grow_on_join")
    script = ChaosScript(ELASTIC_EVENTS, log=print)
    for r in reqs:
        eng.submit(r)
    t_post = w_post = None
    while eng.queue or eng.pending or any(s is not None for s in eng.slot_req):
        ctl.step(script)
        if t_post is None and len(eng.resizes) == len(ELASTIC_EVENTS):
            t_post, w_post = time.perf_counter(), done_of(eng)
    t_end = time.perf_counter()
    post = None
    if t_post is not None and t_end > t_post:
        post = (done_of(eng) - w_post) / (t_end - t_post)
    return eng.results, post


def run_elastic(cfg, workload, el_n, prompt_len, gen_max, slots, seed, device,
                repeats=3) -> list:
    """The two kill/join rows: ``el_n`` requests at ``poisson:0.5``
    through the script, LLM decode on ``workload`` and D-iteration solves
    at n = 60, each against the same traffic uninterrupted at dp 4 (the
    best of ``repeats`` of each, in turns); every visited extent is warmed
    before the timed runs."""
    prompts, budgets = traffic(el_n, prompt_len, gen_max, cfg.vocab, seed + 21)
    arr = arrivals("0.5", el_n, seed + 5)
    scfg = ServeConfig(dp=ELASTIC_DP, steps_per_dispatch=ELASTIC_SPD)

    def llm_reqs():
        return [Request(id=i, arrival=a, prompt=p, max_new=b)
                for i, (p, b, a) in enumerate(zip(prompts, budgets, arr))]

    def llm_run():
        workload.reset()
        eng = ServeEngine(workload, scfg)
        res, post = _run_elastic(eng, llm_reqs(),
                                 lambda e: sum(len(r.output) for r in e.results.values()))
        return eng, res, post

    llm_run()  # warm
    w = slots + 1
    run_continuous_llm(workload, prompts[:w], budgets[:w], [0] * w, "fcfs", dp=ELASTIC_DP,
                       steps_per_dispatch=ELASTIC_SPD)
    steady, (eng, res, post) = best_of_pairs(
        lambda: run_continuous_llm(workload, prompts, budgets, arr, "fcfs", dp=ELASTIC_DP,
                                   steps_per_dispatch=ELASTIC_SPD)[0],
        lambda s: s["throughput_tok_s"], llm_run, lambda t: t[2] or 0.0, repeats)
    se = eng.summary()
    llm_row = {
        "name": "serve_llm_elastic_killjoin", "workload": "llm_decode",
        "trajectory": "4->3->5->4", "resizes": se["resizes"],
        "tok_s": round(se["throughput_tok_s"], 1), "ttft_p95_ms": round(se["ttft_p95_ms"], 2),
        "lost_requests": el_n - len(res), "reprefills": workload.prefills - el_n,
        "tok_s_vs_steady": round(se["throughput_tok_s"] / steady["throughput_tok_s"], 3),
        "tok_s_post_vs_steady": round((post or 0.0) / steady["throughput_tok_s"], 3),
    }

    fp_wl = make_workload("fixedpoint_solve", solver="d_iteration", n=ELASTIC_FP_N,
                          dp=ELASTIC_DP, slots=slots, damping=0.8, seed=seed, device=device)
    rng = np.random.default_rng(seed + 13)
    payloads = []
    for _ in range(el_n):
        v = rng.random(ELASTIC_FP_N).astype(np.float32)
        payloads.append(v / v.sum())
    fp_cfg = ServeConfig(termination="residual_interval", dp=ELASTIC_DP, eps=1e-6,
                         steps_per_dispatch=ELASTIC_SPD)

    def fp_reqs():
        return [Request(id=i, arrival=a, payload=p, max_new=5000)
                for i, (p, a) in enumerate(zip(payloads, arr))]

    def fp_run():
        fp_wl.reset()
        eng = ServeEngine(fp_wl, fp_cfg)
        res, post = _run_elastic(eng, fp_reqs(), lambda e: len(e.results))
        return eng, res, post

    def fp_steady_run():
        fp_wl.reset()
        eng = ServeEngine(fp_wl, fp_cfg)
        eng.run(fp_reqs())
        return eng.summary()

    fp_run()  # warm
    fp_steady_run()
    fp_steady, (eng, fp_res, fp_post) = best_of_pairs(
        fp_steady_run, lambda s: -s["wall_s"], fp_run, lambda t: t[2] or 0.0, repeats)
    fe = eng.summary()
    steady_req_s = el_n / fp_steady["wall_s"]
    fp_row = {
        "name": "serve_fixedpoint_elastic_killjoin", "workload": "fixedpoint_solve",
        "trajectory": "4->3->5->4", "resizes": fe["resizes"], "requests": el_n,
        "req_s": round(len(fp_res) / fe["wall_s"], 2), "lost_requests": el_n - len(fp_res),
        "converged": fe["converged"],
        "req_s_vs_steady": round((len(fp_res) / fe["wall_s"]) / steady_req_s, 3),
        "req_s_post_vs_steady": round((fp_post or 0.0) / steady_req_s, 3),
    }
    return [llm_row, fp_row]


def run_grid(cfg, grid: dict, device, *, params=None, seed: int = 0) -> list:
    """Every row of ``grid`` (:data:`QUICK`'s keys, and optionally
    ``fp_slots``, ``fp_requests``, ``elastic_requests`` and ``repeats``,
    the runs a timed row takes the best of, default 3) for the LLM config
    ``cfg`` on ``device``; ``params`` default to the seed's."""
    slots, n_req = grid["slots"], grid["n_req"]
    repeats = grid.get("repeats", 3)
    prompt_len, gen_max = grid["prompt_len"], grid["gen_max"]
    prompts, budgets = traffic(n_req, prompt_len, gen_max, cfg.vocab, seed)
    workload = make_workload("llm_decode", cfg=cfg, slots=slots, max_len=prompt_len + gen_max + 2,
                             max_prompt_len=prompt_len, seed=seed, params=params, device=device)
    rows = []
    static = best_of(lambda: run_static_llm(cfg, workload.params, prompts, budgets, slots,
                                            device), lambda s: s["tok_s"], repeats)
    rows.append({"name": "serve_static_baseline", "workload": "llm_decode",
                 "tok_s": round(static["tok_s"], 1), "useful_tokens": static["useful_tokens"],
                 "wall_s": round(static["wall_s"], 3)})
    w = slots + 1  # warm the recycled-slot admission too
    run_continuous_llm(workload, prompts[:w], budgets[:w], [0] * w, "fcfs")
    for sched in grid["schedulers"]:
        for akind in grid["arrivals"]:
            arr = arrivals(akind, n_req, seed + 3)
            s = best_of(lambda: run_continuous_llm(workload, prompts, budgets, arr, sched)[0],
                        lambda s: s["throughput_tok_s"], repeats)
            rows.append({
                "name": f"serve_llm_{sched}_{akind}", "workload": "llm_decode",
                "scheduler": sched, "arrival": akind,
                "tok_s": round(s["throughput_tok_s"], 1),
                "ttft_p50_ms": round(s["ttft_p50_ms"], 2),
                "ttft_p95_ms": round(s["ttft_p95_ms"], 2),
                "tpot_p50_ms": round(s["tpot_p50_ms"], 3),
                "tpot_p95_ms": round(s["tpot_p95_ms"], 3),
                "occupancy": round(s["occupancy"], 3),
                "speedup_vs_static": round(s["throughput_tok_s"] / static["tok_s"], 3),
                **mem_fields(workload, s),
            })
    rows.extend(run_sysprefix(cfg, workload.params, slots, n_req, seed + 11, device,
                              **grid["sysprefix"], repeats=repeats))
    el_n = grid.get("elastic_requests", 3 * n_req)  # the reference's 3 x: a settled tail
    rows.extend(run_elastic(cfg, workload, el_n, prompt_len, gen_max, slots, seed, device,
                            repeats))
    del workload
    fcfg = grid["fixedpoint"]
    fp = run_fixedpoint(fcfg["n"], fcfg["dp"], grid.get("fp_slots", slots),
                        grid.get("fp_requests", n_req), fcfg["eps"], "fcfs", seed, device)
    rows.append({"name": "serve_fixedpoint_fcfs", "workload": "fixedpoint_solve",
                 "scheduler": "fcfs", "n": fcfg["n"], "dp": fcfg["dp"],
                 "requests": grid.get("fp_requests", n_req),
                 "req_s": round(fp["req_s"], 2), "static_req_s": round(fp["static_req_s"], 2),
                 "speedup_vs_static": round(fp["req_s"] / fp["static_req_s"], 3),
                 "ticks": fp["ticks"], "static_iters": fp["static_iters"],
                 "occupancy": round(fp["occupancy"], 3), "converged": fp["converged"]})
    return rows


def check_rows(rows) -> None:
    """The reference's gates; raises AssertionError on the first that
    fails."""
    by = {r["name"]: r for r in rows}
    for r in rows:  # a NaN percentile (nothing retired) fails, never passes
        for k, v in r.items():
            if k.endswith("_ms"):
                assert isinstance(v, float) and math.isfinite(v), (
                    f"{r['name']}: percentile {k}={v!r} is not finite")
        if r.get("scheduler") and r["workload"] == "llm_decode":
            for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms", "tpot_p95_ms"):
                assert k in r, f"{r['name']} is missing percentile {k}"
    burst, static = by["serve_llm_fcfs_burst"]["tok_s"], by["serve_static_baseline"]["tok_s"]
    assert burst >= 0.7 * static, (
        f"continuous batching ({burst:.1f} tok/s) fell below 0.7x the static baseline "
        f"({static:.1f} tok/s) at peak arrival")
    for r in rows:
        if r["workload"] == "fixedpoint_solve":
            assert r["converged"] == r["requests"], r
    paged = by["serve_llm_paged_sysprefix"]
    assert paged["bit_exact_vs_contig"], "paged decode diverged from contiguous decode"
    assert paged["concurrency_per_byte_vs_contig"] >= 1.5, paged
    assert paged["tok_s_vs_contig"] >= 0.8, (
        f"paged throughput {paged['tok_s_vs_contig']:.3f}x of contiguous (gate: >= 0.8x)")
    llm_el, fp_el = by["serve_llm_elastic_killjoin"], by["serve_fixedpoint_elastic_killjoin"]
    for r in (llm_el, fp_el):
        assert r["lost_requests"] == 0, f"elastic serving lost requests: {r}"
        assert r["resizes"] == len(ELASTIC_EVENTS), f"resize trajectory incomplete: {r}"
    assert llm_el["reprefills"] == 0, f"an elastic resize prefilled slots again: {llm_el}"
    assert llm_el["tok_s_post_vs_steady"] >= 0.8, (
        f"tok/s after the resizes fell below 0.8x steady: {llm_el}")
    assert fp_el["req_s_post_vs_steady"] >= 0.8, (
        f"req/s after the resizes fell below 0.8x steady: {fp_el}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--json", default="chiprun_out/bench_serve.json", help="output JSON path")
    ap.add_argument("--quick", action="store_true", help="reduced grid")
    ap.add_argument("--check", action="store_true", help="assert the gates")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    arch = "llama3.2-1b"
    grid = QUICK if args.quick else FULL
    rows = run_grid(registry.get_smoke_config(arch), grid, device)
    for r in rows:
        print(f"{r['name']},{r.get('tok_s', r.get('req_s'))},{r.get('speedup_vs_static', '')}")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    payload = {"meta": {"arch": arch, "smoke": True, "device": kind, "quick": args.quick,
                        "baseline": "static waves",
                        **{k: v for k, v in grid.items() if k in (
                            "slots", "n_req", "prompt_len", "gen_max")}},
               "sweep": rows}
    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=2))
    print(f"# wrote {out}")
    if args.check:
        check_rows(rows)
        print("# sanity OK: continuous vs static, fixedpoint all certified, paged token for "
              "token the contiguous pool")
    return payload


if __name__ == "__main__":
    main()
