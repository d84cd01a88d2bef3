"""What adding the tensor-parallel sums in fp32 costs: ``sharding._all_reduce``
widens a bf16 sum to fp32 (``sharding._WIDEN``) and rounds it once.  In
one world, one process a card:

1. one all-reduce over ``"model"`` of a decode tick's [8, d] bf16
   activations (d 2048 and 5120, llama3.2-1b's and qwen2.5-32b's), in
   four forms, 200 calls each after 20 warm-ups, host microseconds a call
   (``time.perf_counter``) and device microseconds a call (CUDA events
   around the 200), the forms timed in the order a b c d d c b a:

   - ``widened``: the port's ``_all_reduce`` (one fp32 copy, the sum, the
     cast back);
   - ``widened_clone``: the form it replaced (``x.float()``, then
     ``.contiguous().clone()``: two fp32 allocations, two copies);
   - ``bf16``: ``_all_reduce`` with ``_WIDEN`` empty (one bf16 copy, the
     sum);
   - ``in_place``: ``dist.all_reduce`` of one bf16 buffer (no allocation,
     no copy);

2. the serving CLI's run (``launch.serve.run``) four times, the widening
   on, off, off, on: the same weights and requests each time.

Rank 0 writes one JSON record: the card, the microseconds of each form
(both of its passes), each run's summary (TTFT, TPOT, throughput, wall)
and whether each run's tokens equal the first run's.  From the root of
the repository, on four cards:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/tp_widen_ab.py --out chiprun_out/tp_widen_ab.json \\
        -- --arch llama3.2-1b --continuous --workload llm_decode_paged \\
        --attn kernel --dp 3 --slots 8 --requests 8 --prompt-len 64 --gen 16 \\
        --block-size 16 --tp 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

WIDEN = shd._WIDEN


def widened_clone(x, ax):
    y = x.float().contiguous().clone()
    dist.all_reduce(y, group=ax.group)
    return y.to(x.dtype)


def in_place(x, ax):
    dist.all_reduce(x, group=ax.group)
    return x


def bf16(x, ax):
    shd._WIDEN = ()
    try:
        return shd._all_reduce(x, ax)
    finally:
        shd._WIDEN = WIDEN


FORMS = {"widened": shd._all_reduce, "widened_clone": widened_clone, "bf16": bf16,
         "in_place": in_place}


def time_form(fn, x, ax, device) -> dict:
    """Host and device microseconds a call (no device time on the CPU)."""
    cuda = device.type == "cuda"
    for _ in range(20):
        fn(x, ax)
    if cuda:
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t = time.perf_counter()
    for _ in range(200):
        fn(x, ax)
    host = (time.perf_counter() - t) / 200 * 1e6
    if not cuda:
        return {"host_us": host, "device_us": None}
    end.record()
    torch.cuda.synchronize(device)
    return {"host_us": host, "device_us": start.elapsed_time(end) / 200 * 1e3}


def build_kernels() -> None:
    """Every kernel source built at once (rank 0; the others wait)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.selective_scan import ops as ss

    sources = {"flash_attention": fa.SOURCE, "paged_attention": pa.SOURCE,
               "rmsnorm": rn.SOURCE, "selective_scan": ss.SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(build.build_shared_library, s, n) for n, s in sources.items()]:
            f.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/tp_widen_ab.py")
    ap.add_argument("--out", required=True)
    ap.add_argument("serve", nargs=argparse.REMAINDER, help="the serving CLI's arguments")
    ns = ap.parse_args(argv)
    args = cli.build_parser().parse_args([a for a in ns.serve if a != "--"])
    env = train_cli.world_env()
    if env is None:
        raise SystemExit("run under torch.distributed.run, one process a card")
    device = train_cli.start_world(env, args.device)
    rank0 = dist.get_rank() == 0
    rec = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "tp": args.tp, "argv": ns.serve}
    try:
        if rank0 and device.type == "cuda":
            build_kernels()
        dist.barrier()
        mesh = train_cli.build_mesh(1, args.tp, device.type)
        args.device = str(device)
        ax = shd.ShardingContext(None, None, mesh).axis(shd.MODEL)
        micro = {}
        for d in (2048, 5120):
            x = torch.randn(8, d, device=device, dtype=torch.bfloat16)
            order = list(FORMS) + list(reversed(FORMS))
            for name in order:
                micro.setdefault(f"d{d}/{name}", []).append(time_form(FORMS[name], x, ax, device))
        rec["allreduce_8xd_bf16"] = micro
        runs, first = [], None
        for widen in (True, False, False, True):
            shd._WIDEN = WIDEN if widen else ()
            try:
                eng = cli.run(args, mesh)
            finally:
                shd._WIDEN = WIDEN
            tokens = {i: [int(t) for t in np.asarray(r.output)] for i, r in eng.results.items()}
            first = first or tokens
            s = eng.summary()
            runs.append({"widen": widen, "tokens_equal_first": tokens == first,
                         **{k: s[k] for k in ("completed", "ticks", "throughput_tok_s",
                                              "ttft_p50_ms", "tpot_p50_ms", "tpot_p95_ms",
                                              "wall_s")}})
            del eng
        rec["serve_runs"] = runs
    finally:
        dist.destroy_process_group()
    if rank0:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(json.dumps(rec, indent=1))
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
