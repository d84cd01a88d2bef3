"""Paper S2 table (port of ``benchmarks/bench_mrd.py``): the MRD cost
model (steps, messages per cycle against the paper's closed forms, and the
alpha-beta time of MRD, Rabenseifner, ring and tree allreduces over an H100
node's NVLink and an NDR InfiniBand port), plus measured sweeps of the plan
layer on the sim executor: every (schedule x transform) pair the registries
can bind, and a many-leaf gradient tree allreduced per leaf, flat and
bucketed (``run_bucketed``, stage-major across buckets).

    python -m repro_torch.benchmarks.bench_mrd [--quick] [--device cuda]
        [--json chiprun_out/bench_mrd.json]

CSV on stdout: name,us_per_call,derived.  The JSON holds ``{"device",
"model", "measured"}``; every measured row names the device it ran on.
The link constants are datasheet rates with assumed latencies (see
``collectives.schedules.LinkModel``): the model rows are a model, not a
measurement.  ``--quick`` runs fewer p values and iterations; its row
names are a subset of the full run's.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.collectives import SCHEDULES, TRANSFORMS, plans
from repro_torch.collectives import schedules as S
from repro_torch.device import resolve_device

LINKS = {"nvlink": S.LinkModel.h100_nvlink, "ib": S.LinkModel.ndr_infiniband}


def model_rows():
    out = []
    # closed-form validation: messages and steps per cycle
    for p in (2, 3, 4, 5, 7, 8, 12, 16, 24, 32, 64, 100, 256):
        sched = S.allreduce_schedule(p)
        msgs = S.schedule_messages(sched)
        if msgs != S.paper_message_count(p) or len(sched) != S.paper_step_count(p):
            raise AssertionError(f"p={p}: the schedule's counts are not the paper's")
        out.append((f"mrd_messages_p{p}", 0.0, msgs))
        out.append((f"mrd_steps_p{p}", 0.0, len(sched)))
    # alpha-beta modeled time of a 100 MB gradient buffer
    n_bytes = 100 * 2**20
    for link_name, make in LINKS.items():
        link = make()
        for p in (8, 16, 64, 256):
            times = {
                "mrd": S.schedule_time(S.allreduce_schedule(p), n_bytes, link),
                "rabenseifner": S.schedule_time(S.rabenseifner_schedule(p), n_bytes, link),
                "ring": S.ring_allreduce_time(p, n_bytes, link),
                "tree": S.tree_allreduce_time(p, n_bytes, link),
            }
            for name, t in times.items():
                out.append((f"model_{name}_100MB_{link_name}_p{p}", t * 1e6, round(t * 1e3, 3)))
        # latency regime: the paper's case, an 8-byte residual scalar
        for p in (16, 256):
            t_mrd = S.schedule_time(S.allreduce_schedule(p), 8, link)
            t_ring = S.ring_allreduce_time(p, 8, link)
            out.append((f"model_mrd_scalar_{link_name}_p{p}", t_mrd * 1e6, round(t_mrd * 1e6, 2)))
            out.append((f"model_ring_scalar_{link_name}_p{p}", t_ring * 1e6,
                        round(t_ring * 1e6, 2)))
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn, device, iters: int, reps: int = 3) -> float:
    """Best of ``reps`` of the mean wall time of ``iters`` calls, each run
    to its end on the device."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    return best


def measured_rows(device, quick: bool = False):
    """Every (schedule x transform) pair the plan layer can bind on the sim
    executor (``hierarchical`` needs two mesh axes: device executors only;
    ``mrd`` x ``int8`` requantizes the full buffer every stage and is never
    the fast choice, so it is skipped as the reference skips it)."""
    out = []
    gen = np.random.default_rng(0)
    for p in ((8, 12) if quick else (8, 12, 16, 32)):
        p0 = S.pivot(p)[0]
        n = max(4096, p0 * 256)
        x = torch.from_numpy(gen.standard_normal((p, n)).astype(np.float32)).to(device)
        for sched_name, fam in sorted(SCHEDULES.items()):
            if fam.min_axes > 1:
                continue
            for tf_name in sorted(TRANSFORMS):
                if tf_name != "identity" and sched_name == "mrd":
                    continue
                plan = plans.allreduce_plan(schedule=sched_name, p=p, op="sum",
                                            transform=tf_name)
                xp = torch.nn.functional.pad(x, (0, (-n) % plan.pad_quantum()))
                us = _time_us(lambda: plan.run(xp), device, iters=5 if quick else 20)
                out.append({"name": f"sim_{sched_name}_{tf_name}_p{p}_n{xp.shape[1]}",
                            "schedule": sched_name, "transform": tf_name, "p": p,
                            "n": int(xp.shape[1]), "us_per_call": round(us, 1)})
    return out


def bucketed_rows(device, quick: bool = False):
    """A 64-leaf fp32 tree allreduced per leaf (one schedule cycle a
    tensor), flat (one ravelled vector) and bucketed (``run_bucketed``, ~6
    buckets).  Eager execution: every stage of every tensor pays a launch,
    the analogue of the per-message alpha the per-leaf path pays once a
    tensor on an interconnect; the bucketed row carries its speedups."""
    out = []
    gen = np.random.default_rng(0)
    n_leaves = 64
    for p in ((8,) if quick else (8, 12)):
        sizes = [int(s) for s in gen.integers(64, 2048, n_leaves)]
        tree = {f"g{i:02d}": torch.from_numpy(
            gen.standard_normal((p, s)).astype(np.float32)).to(device)
            for i, s in enumerate(sizes)}
        total = sum(sizes)
        plan = plans.allreduce_plan(schedule="mrd", p=p, op="sum")
        bucket_bytes = (total * 4) // 6

        def flat():
            vec = torch.cat([leaf.reshape(p, -1) for leaf in tree.values()], dim=1)
            red = plan.run(torch.nn.functional.pad(vec, (0, (-vec.shape[1]) % plan.pad_quantum())))
            return red[:, : vec.shape[1]]

        variants = {"perleaf": lambda: plan.run(tree), "flat": flat,
                    "bucketed": lambda: plan.run_bucketed(tree, bucket_bytes=bucket_bytes)}
        times = {name: _time_us(fn, device, iters=2 if quick else 4)
                 for name, fn in variants.items()}
        for name, us in times.items():
            row = {"name": f"sim_grad{n_leaves}_{name}_eager_p{p}", "schedule": "mrd",
                   "transform": "identity", "p": p, "n": total, "n_leaves": n_leaves,
                   "us_per_call": round(us, 1)}
            if name == "bucketed":
                row["speedup_vs_perleaf"] = round(times["perleaf"] / us, 2)
                row["speedup_vs_flat"] = round(times["flat"] / us, 2)
            out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="fewer p values and iterations (a smoke run)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="chiprun_out/bench_mrd.json", help="output JSON path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    model = model_rows()
    measured = measured_rows(device, args.quick) + bucketed_rows(device, args.quick)
    for row in measured:
        row["device"] = name
    for n, us, derived in model:
        print(f"{n},{us},{derived}")
    for r in measured:
        print(f"{r['name']},{r['us_per_call']},{r['p']}")
    payload = {"device": name,
               "model": [{"name": n, "us_per_call": us, "derived": d} for n, us, d in model],
               "measured": measured}
    path = Path(args.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))
    print(f"# wrote {path} ({name})")
    return payload


if __name__ == "__main__":
    main()
