"""Asynchrony-runtime sweep (port of ``benchmarks/bench_async.py``): delay
model x detection protocol on the paper's 1-D BVP relaxation.

For every registered delay model, every realizable protocol is compared
against the ``oracle`` baseline (the physically unrealizable true residual
of the live iterate) on the same seeds, one :func:`sweep` per (model,
protocol) pair:

- **detection delay**: mean extra ticks past the oracle's stopping tick;
- **message counts**: point-to-point + collective (paper S2 accounting);
- **soundness**: worst certified-vs-true residual across the seeds.

Each row also records the sweep's lanes, the ticks its loop ran (the
slowest lane's) and its wall time on ``--device``.

    python -m repro_torch.benchmarks.bench_async [--quick] [--check] [--device cuda]

CSV on stdout (name,us_per_call,derived); the rows as JSON to ``--json``
(default ``chiprun_out/bench_async.json``).  ``--quick`` cuts the grid for
a smoke run (its row names are a subset of the full run's).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.asynchrony import (
    DELAY_MODELS,
    AsyncConfig,
    make_solver,
    record_detection_delay,
    sweep,
)
from repro_torch.configs.paper_poisson1d import CONFIG as PAPER
from repro_torch.device import resolve_device

PROTOCOLS = ("sync", "inexact", "exact", "interval")  # vs 'oracle' baseline


def _row(model: str, det: str, p: int, r, wall_s: float, base_ticks=None) -> dict:
    lanes = int(r.ticks.size)
    row = {"name": f"async_{model}_{det}_ticks_p{p}", "model": model, "protocol": det, "p": p,
           "us_per_call": round(wall_s / lanes * 1e6, 1), "lanes": lanes,
           "slowest_ticks": int(r.ticks.max()), "wall_s": wall_s}
    if not r.detected.all():
        # budget-capped: delay deltas would be meaningless
        return {**row, "undetected": True}
    delay = 0.0 if base_ticks is None else record_detection_delay(det, r.ticks, base_ticks)
    return {
        **row,
        "mean_ticks": round(float(r.ticks.mean()), 1),
        # 'sync' runs a different (delay-free) environment, so its delta vs
        # the async oracle is an environment gap, not a detection delay
        "detection_delay_ticks": round(delay, 1),
        "messages_p2p": int(r.messages_p2p.mean()),
        "messages_coll": int(r.messages_coll.mean()),
        "worst_true_res": float(r.true_res.max()),
    }


def run_sweeps(n: int, p: int, seeds, models, eps: float, *, device="cuda", on_sweep=None):
    """The bench's rows for ``models`` x (oracle + :data:`PROTOCOLS`) on
    poisson1d at ``n``; ``on_sweep(row, result)`` sees each sweep."""
    fp = make_solver("poisson1d", n=n, omega=1.0, shift=PAPER.shift, seed=0)
    rows = []
    for model in models:
        base = None
        for det in ("oracle",) + PROTOCOLS:
            cfg = AsyncConfig(p=p, detection=det, delay_model=model, eps=eps, max_ticks=60000,
                              max_delay=PAPER.max_delay, activity=PAPER.activity)
            t0 = time.perf_counter()
            r = sweep(fp, cfg, seeds, device=device)
            row = _row(model, det, p, r, time.perf_counter() - t0,
                       None if det == "oracle" else base.ticks)
            rows.append(row)
            if on_sweep is not None:
                on_sweep(row, r)
            if det == "oracle":
                if row.get("undetected"):
                    break  # no baseline: the model's other rows would be meaningless
                base = r
    return rows


def check_rows(rows) -> int:
    """Every *detected* realizable async protocol must stop at or after the
    oracle: a negative detection delay would mean certifying convergence
    before the ground truth reached eps (an unsound detector).  ``sync`` is
    excluded (a different, delay-free environment).  Returns the number of
    rows checked."""
    checked = 0
    for r in rows:
        if r.get("undetected") or r["protocol"] in ("oracle", "sync"):
            continue
        if r["detection_delay_ticks"] < 0:
            raise AssertionError(f"unsound: {r['name']} stopped {-r['detection_delay_ticks']} "
                                 "ticks before the oracle")
        if not np.isfinite(r["worst_true_res"]):
            raise AssertionError(f"non-finite residual: {r}")
        checked += 1
    if not checked:
        raise AssertionError("no detected protocol rows to sanity-check")
    return checked


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--json", default="chiprun_out/bench_async.json", help="output JSON path")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep: fewer models and seeds, a smaller problem")
    ap.add_argument("--check", action="store_true",
                    help="assert every detected realizable protocol stops at or after the oracle")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = 256 if args.quick else 512
    p = 4 if args.quick else 8
    n_seeds = 4 if args.quick else 16
    models = ("bernoulli", "straggler") if args.quick else tuple(sorted(DELAY_MODELS))
    rows = run_sweeps(n, p, list(range(n_seeds)), models, PAPER.eps, device=device)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']},{r.get('detection_delay_ticks', 'undetected')}")
    path = Path(args.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "meta": {"n": n, "p": p, "seeds": n_seeds, "eps": PAPER.eps, "quick": args.quick,
                 "baseline": "oracle", "device": str(device)},
        "sweep": rows,
    }, indent=2))
    print(f"# wrote {path}")
    if args.check:
        print(f"# sanity OK: detection delay >= oracle on {check_rows(rows)} rows")
    return rows


if __name__ == "__main__":
    main()
