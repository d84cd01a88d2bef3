"""The paper's S4 experiment on the port's asynchrony runtime
(``repro_torch.asynchrony``): asynchronous relaxation of a 1-D two-point
boundary-value problem, comparing detection protocols
(``DETECTION_PROTOCOLS``) in a 'concentrated' environment.

Shows the Fig. 5 qualitative result: in a low-delay environment the
asynchronous iteration count tracks the synchronous one, while message
counts are higher.  The closing sweep runs seeds x a grid of delay-model
parameters as one batch of lanes with :func:`sweep`.

Run:  python -m repro_torch.examples.solve_poisson_async [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.asynchrony import AsyncConfig, make_solver, run, sweep
from repro_torch.configs.paper_poisson1d import CONFIG as PAPER
from repro_torch.device import resolve_device

N = 512  # (paper: 10000 with shift=0, slow contraction; see bench_detection)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"{'p':>3} {'mode':>9} {'ticks':>7} {'iters(min..max)':>16} "
          f"{'msgs':>9} {'certified':>10} {'true res':>10}")
    for p in (2, 4, 8):
        fp = make_solver("poisson1d", n=N, omega=1.0, shift=PAPER.shift, seed=0)
        for mode in ("sync", "exact", "inexact", "interval"):
            cfg = AsyncConfig(p=p, detection=mode, eps=PAPER.eps, max_ticks=60000,
                              max_delay=PAPER.max_delay, activity=PAPER.activity, seed=p)
            r = run(fp, cfg, device=device)
            print(f"{p:>3} {mode:>9} {r.ticks:>7} "
                  f"{str(r.kiter.min()) + '..' + str(r.kiter.max()):>16} "
                  f"{r.messages_p2p + r.messages_coll:>9} "
                  f"{r.res_glb:>10.2e} {r.true_res:>10.2e}")

    print("\nNote: 'exact' certifies ||f(x̄)-x̄|| < eps on a consistent snapshot "
          "(always true at detection); 'inexact' may stop early (paper Alg. 1); "
          "'interval' certifies a whole window of small updates.")

    # --- one batch of lanes: seeds x bernoulli activity grid -----------------
    fp = make_solver("poisson1d", n=128, omega=1.0, shift=PAPER.shift, seed=0)
    cfg = AsyncConfig(p=4, detection="exact", eps=PAPER.eps, max_ticks=60000,
                      max_delay=PAPER.max_delay)
    grid = {"activity": torch.tensor([0.3, 0.6, 0.95])}
    sw = sweep(fp, cfg, seeds=range(8), delay_params=grid, device=device)
    print("\nsweep(): 3 activity levels x 8 seeds as one batch of 24 lanes")
    for gi, act in enumerate(grid["activity"].tolist()):
        print(f"  activity={act:.2f}: mean ticks {sw.ticks[gi].mean():7.1f}, "
              f"all certified: {bool(sw.detected[gi].all())}, "
              f"worst true res {sw.true_res[gi].max():.2e}")
    return sw


if __name__ == "__main__":
    main()
