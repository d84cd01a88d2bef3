"""Where a stacked train step's memory peaks, on the CPU.

Runs one step of the train CLI (``repro_torch.launch.train.main``) on the
CPU under ``torch.profiler`` with its memory recording, at llama3.2-1b's
proportions cut to a width the CPU takes in seconds (d_model 512, 16
layers, a 32,000-token vocabulary: the embedding is 0.27 of the params, as
at full width), and prints the allocator's peak and, for each labelled
function of the grad sync (the segmented backward, the bucket pipeline's
admissions and advances, the EF round trip, the plans), the allocated
bytes before it, its peak and after it.  The numbers are the CPU
allocator's, not a device's; what they show is which part of the step
holds what, and that scales with the buckets' bytes.

    PYTHONPATH=src python scripts/step_memory_trace.py --grad-sync compressed --overlap
    PYTHONPATH=src python scripts/step_memory_trace.py --grad-sync compressed --no-overlap
"""

from __future__ import annotations

import argparse
import bisect
import functools
import json
import os
import tempfile
from unittest import mock

from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.collectives import plans
from repro_torch.collectives import transforms
from repro_torch.configs import registry
from repro_torch.distributed.gradsync import common, overlap
from repro_torch.launch import train

LABELLED = ((overlap, "drive"), (overlap, "_grads"), (common, "stacked_grad_buckets"),
            (plans.BucketPipeline, "admit"), (plans.BucketPipeline, "advance"),
            (plans.BucketPipeline, "drain"), (transforms, "ef_roundtrip_"))
SPAN = "W:"


def label(owner, name: str) -> None:
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(SPAN + name):
            return fn(*a, **k)

    setattr(owner, name, wrapped)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grad-sync", default="compressed")
    ap.add_argument("--dp", type=int, default=3)
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction, default=False)
    args = ap.parse_args()
    for owner, name in LABELLED:
        label(owner, name)
    cfg = registry.override(registry.get_config("llama3.2-1b"), d_model=512, n_layers=16,
                            n_heads=8, n_kv_heads=2, head_dim=64, d_ff=2048, vocab=32000)
    argv = ["--arch", "llama3.2-1b", "--steps", "1", "--batch", str(2 * args.dp), "--seq", "128",
            "--dp", str(args.dp), "--grad-sync", args.grad_sync, "--remat", "full",
            "--device", "cpu", "--overlap" if args.overlap else "--no-overlap"]
    with mock.patch.dict(registry._FULL, {"llama3.2-1b": cfg}):
        with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
            train.main(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    mem = sorted((e["ts"], e["args"].get("Total Allocated", 0)) for e in events
                 if e.get("name") == "[memory]")
    stamps = [ts for ts, _ in mem]

    def at(ts: float) -> float:
        i = bisect.bisect_right(stamps, ts) - 1
        return mem[i][1] / 2**20 if i >= 0 else 0.0

    def peak(a: float, b: float) -> float:
        i, j = bisect.bisect_left(stamps, a), bisect.bisect_right(stamps, b)
        return max([v for _, v in mem[i:j]] or [mem[i - 1][1] if i else 0]) / 2**20

    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e["name"].startswith((SPAN, plans.PROFILE_RANGE))),
                   key=lambda e: e["ts"])
    print(f"{args.grad_sync} dp {args.dp} {'--overlap' if args.overlap else '--no-overlap'}: "
          f"peak allocated {max(v for _, v in mem) / 2**20:.1f} MiB (CPU allocator)")
    for n, e in enumerate(spans):
        a, b = e["ts"], e["ts"] + e["dur"]
        print(f"  {n:3d}  {e['name']:28s} before {at(a - 1e-3):8.1f}  "
              f"peak {peak(a, b):8.1f}  after {at(b):8.1f} MiB")


if __name__ == "__main__":
    main()
