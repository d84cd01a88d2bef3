"""Continuous batching on the ``ServeEngine`` API (port of
``examples/serve_decode.py``), on an SSM arch (a recurrent state per slot)
to show the slot machinery beyond transformer KV caches.

Requests with mixed prompt lengths and budgets arrive over time; the pool
admits each one by prefilling it into a free (or recycled) slot while
every other slot keeps decoding, and the ``eos_maxlen`` termination
retires slots through the paper's non-blocking agreement reduction.  Each
request's tokens are the ones it would get decoded alone.

Run:  python -m repro_torch.examples.serve_decode [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = registry.get_smoke_config("falcon-mamba-7b")
    workload = make_workload("llm_decode", cfg=cfg, slots=3, max_len=40, max_prompt_len=12,
                             seed=0, device=device)
    engine = ServeEngine(workload, ServeConfig(scheduler="fcfs", termination="eos_maxlen"))

    # 8 requests over 3 slots: mixed prompt lengths (3..12), mixed budgets
    # (4..16), staggered arrivals -> admissions recycle retired slots
    rng = np.random.default_rng(0)
    requests = [
        Request(id=i, arrival=int(rng.integers(0, 10)),
                prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(3, 13))),
                max_new=int(rng.integers(4, 17)))
        for i in range(8)
    ]
    results = engine.run(requests)

    for i in sorted(results):
        r = results[i]
        print(f"req {r.id}: arrival t={r.arrival:>2}  admitted t={r.admit_tick:>2}  "
              f"retired t={r.retire_tick:>2}  {r.n_tokens:>2} tokens  "
              f"head {r.output[:6].tolist()}")
    s = engine.summary()
    print(f"\n{s['completed']} requests, {s['ticks']} ticks: "
          f"{s['throughput_tok_s']:.1f} tok/s, occupancy {s['occupancy']:.2f}, "
          f"TTFT p50 {s['ttft_p50_ms']:.1f} ms, TPOT p50 {s['tpot_p50_ms']:.2f} ms")
    return engine


if __name__ == "__main__":
    main()
