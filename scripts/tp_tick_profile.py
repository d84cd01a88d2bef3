"""Where a tensor-parallel serving tick's time goes: the serving CLI's run
under ``torch.profiler`` on rank 0, and the latency of one small NCCL
all-reduce over the ``"model"`` ranks.

    # four cards: one process a card, the TP world of --tp ranks
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/tp_tick_profile.py --out chiprun_out/tp_profile_tp4.json \\
        -- --arch llama3.2-1b --continuous --workload llm_decode_paged --tp 4
    # the same serving run on one card
    python scripts/tp_tick_profile.py --out chiprun_out/tp_profile_tp1.json \\
        -- --arch llama3.2-1b --continuous --workload llm_decode_paged

Rank 0 writes one JSON record: the run's wall seconds and summary, the
device busy time (every kernel), NCCL's kernels' time and count, the
kernel launches, the host-side time of the CPU ops (the profiler's
self CPU time, its own cost included), and, in a world, the host and
device microseconds of one all-reduce of a decode tick's [8, d] bf16
activations over ``"model"`` (the mean of 200 after 20 warm-ups).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402


def allreduce_us(mesh, d: int, device) -> dict:
    """Host and device microseconds of one [8, d] bf16 sum over
    ``"model"`` (device time by CUDA events around the 200 calls; none on
    the CPU)."""
    group = mesh.get_group("model")
    x = torch.randn(8, d, device=device, dtype=torch.bfloat16)
    for _ in range(20):
        dist.all_reduce(x, group=group)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(x, group=group)
    host = (time.perf_counter() - t) / 200 * 1e6
    if not cuda:
        return {"host_us": host, "device_us": None}
    end.record()
    torch.cuda.synchronize(device)
    return {"host_us": host, "device_us": start.elapsed_time(end) / 200 * 1e3}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled_run(args, mesh, device) -> dict:
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng = cli.run(args, mesh)
        _sync(device)
    wall = time.perf_counter() - t
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    cpu_ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    s = eng.summary()
    top = sorted(cpu_ops, key=lambda e: -e.self_cpu_time_total)[:12]
    return {"wall_s": wall, "summary": {k: s[k] for k in (
                "completed", "ticks", "decode_ticks", "throughput_tok_s", "ttft_p50_ms",
                "tpot_p50_ms", "wall_s")},
            "busy_ms": sum(e.device_time_total for e in kernels) / 1e3,
            "kernel_launches": len(kernels),
            "nccl_ms": sum(e.device_time_total for e in nccl) / 1e3, "nccl_kernels": len(nccl),
            "host_self_cpu_ms": sum(e.self_cpu_time_total for e in cpu_ops) / 1e3,
            "top_host_ops_ms": {e.key: e.self_cpu_time_total / 1e3 for e in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/tp_tick_profile.py")
    ap.add_argument("--out", required=True)
    ap.add_argument("serve", nargs=argparse.REMAINDER, help="the serving CLI's arguments")
    ns = ap.parse_args(argv)
    argv_serve = [a for a in ns.serve if a != "--"]
    args = cli.build_parser().parse_args(argv_serve)
    env = train_cli.world_env()
    if env is None:
        device = torch.device(args.device)
        rec = {"tp": 1, **profiled_run(args, None, device)}
    else:
        device = train_cli.start_world(env, args.device)
        try:
            mesh = train_cli.build_mesh(1, args.tp, device.type)
            args.device = str(device)
            if dist.get_rank() == 0:
                rec = {"tp": args.tp, **profiled_run(args, mesh, device)}
            else:
                cli.run(args, mesh)
            from repro_torch.configs import registry

            cfg = registry.get_smoke_config if args.smoke else registry.get_config
            d = cfg(args.arch).d_model
            us = allreduce_us(mesh, d, device)
            if dist.get_rank() == 0:
                rec["allreduce_8xd_bf16"] = us
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) != 0:
            return 0
    rec["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
    Path(ns.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
