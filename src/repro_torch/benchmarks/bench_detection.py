"""Paper Fig. 5 analogue (port of ``benchmarks/bench_detection.py``):
asynchronous vs synchronous iterations of the 1-D two-point BVP relaxation
in a 'concentrated' environment, with the paper's detection protocols.

Reports per p: ticks to detection, per-worker iteration counts, messages
(point-to-point + collective), certified vs true residual.  The paper's
qualitative claims: (1) in a concentrated (low-delay) cluster, async
iteration counts track the synchronous ones; (2) async sends more
messages; (3) the exact detector certifies a genuine solution, the
inexact one may stop early but within acceptable precision.  The last row
runs the paper's own size (n = 10,000, shift 0) for 300 ticks.

    python -m repro_torch.benchmarks.bench_detection [--device cuda]

CSV: name,us_per_call,derived
"""

from __future__ import annotations

import argparse
import time

from repro_torch.asynchrony import AsyncConfig, make_solver, run
from repro_torch.configs.paper_poisson1d import CONFIG as PAPER
from repro_torch.device import resolve_device


def run_one(p, mode, *, device, n=1024, eps=1e-5, seed=0):
    fp = make_solver("poisson1d", n=n, omega=1.0, shift=PAPER.shift, seed=seed)
    cfg = AsyncConfig(p=p, detection=mode, eps=eps, max_ticks=60000, seed=seed,
                      max_delay=PAPER.max_delay, activity=PAPER.activity)
    t0 = time.perf_counter()
    res = run(fp, cfg, device=device)
    return res, (time.perf_counter() - t0) * 1e6


def paper_scale_row(device, ticks: int = 300):
    """The paper's problem at its size (n = 10,000, shift 0: rho ~ 1 -
    O(1/n^2)), ``oracle`` at p = 16 for ``ticks`` ticks: the residual
    left, and the run's wall time in us."""
    fp = make_solver("poisson1d", n=PAPER.n, omega=1.0, shift=0.0, seed=0)
    cfg = AsyncConfig(p=16, detection="oracle", eps=1e-30, max_ticks=ticks)
    t0 = time.perf_counter()
    res = run(fp, cfg, device=device)
    return res, (time.perf_counter() - t0) * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    rows = []
    for p in (2, 4, 8, 16):
        r_sync, w_sync = run_one(p, "sync", device=device)
        r_exact, w_exact = run_one(p, "exact", device=device)
        r_inex, w_inex = run_one(p, "inexact", device=device)
        r_orac, _ = run_one(p, "oracle", device=device)
        rows.append((f"fig5_sync_ticks_p{p}", w_sync, r_sync.ticks))
        rows.append((f"fig5_async_exact_ticks_p{p}", w_exact, r_exact.ticks))
        rows.append((f"fig5_async_inexact_ticks_p{p}", w_inex, r_inex.ticks))
        rows.append((f"fig5_oracle_ticks_p{p}", 0.0, r_orac.ticks))
        rows.append((f"fig5_sync_msgs_p{p}", 0.0, r_sync.messages_p2p + r_sync.messages_coll))
        rows.append((f"fig5_async_msgs_p{p}", 0.0, r_exact.messages_p2p + r_exact.messages_coll))
        rows.append((f"fig5_exact_true_res_p{p}", 0.0, f"{r_exact.true_res:.2e}"))
        rows.append((f"fig5_inexact_true_res_p{p}", 0.0, f"{r_inex.true_res:.2e}"))
        rows.append((f"fig5_async_iter_spread_p{p}", 0.0,
                     f"{r_exact.kiter.min()}..{r_exact.kiter.max()}"))
    res, wall = paper_scale_row(device)
    rows.append(("paper_n10000_res_after_300_ticks", wall, f"{res.res_glb:.4e}"))
    for name, us, derived in rows:
        print(f"{name},{us},{derived}")
    return rows


if __name__ == "__main__":
    main()
