"""The elastic trainer in a world of one process a rank, against the
stacked-rows elastic trainer under the same chaos script, or at ``--tp``
> 1 against its own uninterrupted run.

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      scripts/elastic_cards.py --grad-sync compressed --out chiprun_out/elastic_cards
  python scripts/elastic_cards.py --stacked --grad-sync compressed --out chiprun_out/elastic_cards
  python scripts/elastic_cards.py --compare --grad-sync compressed --out chiprun_out/elastic_cards
  # a (2, 2) world: 2 steps, rank 1's slice killed, its two ranks rejoining
  # at step 4, 8 steps in one go; then the same script for 6 steps,
  # checkpointed, and 2 more steps resumed from the checkpoint, held to
  # the uninterrupted run
  python -m torch.distributed.run --standalone --nproc-per-node 4 scripts/elastic_cards.py \\
      --grad-sync gspmd --tp 2 --kill 2:1 --join 4:0,1 --steps 8
  python -m torch.distributed.run --standalone --nproc-per-node 4 scripts/elastic_cards.py \\
      --grad-sync gspmd --tp 2 --kill 2:1 --join 4:0,1 --steps 6 --ckpt-dir ck
  python -m torch.distributed.run --standalone --nproc-per-node 4 scripts/elastic_cards.py \\
      --grad-sync gspmd --tp 2 --steps 2 --ckpt-dir ck --resume
  python scripts/elastic_cards.py --compare --grad-sync gspmd --tp 2

llama3.2-1b at full width (``--layers`` cuts its depth, ``--smoke`` takes
its reduced config) trains ``--steps`` steps of ``--batch`` x ``--seq``
tokens from ranks 0-3 under the ``grow_on_join`` policy, AdamW at 5e-3,
and the chaos script of ``--kill``/``--join`` (``runtime.chaos.parse_chaos``;
by default ``--kill 2:1 --join 4:1``: 4 -> 3 at step 2, back to 4 at step
4, the killed rank joining again).
Under ``torch.distributed.run`` each rank (NCCL with a card a rank, gloo
with ``--device cpu``) writes ``<out>/<name>_rank<r>.json``
(:func:`record_name`): its losses (None for a step it sat out), the
trajectory, each resize's times, ms a step, its peak memory, and the
digest of its final view of the state (the
params, its EF residual, and its master/moment rows if it owns a ZeRO-1
segment).  ``--stacked`` runs the stacked-rows trainer on one device and
writes ``<out>/<grad-sync>_stacked.json`` with every final rank's view's
digest; ``--compare`` holds every live rank to the stacked trainer's row
(losses and digest equal) and exits 1 otherwise; every record counts the
``mrd_combine`` launches of its run.  The world is launched at
the largest extent the script reaches (``torch.distributed.run``'s
process count: the initial ranks and the spares).

``--grad-sync`` takes ``gspmd`` too, and ``--tp`` > 1 makes
the initial mesh ``("data", "model")`` of ``(4 / tp, tp)`` over ranks
0-3 (a kill drops its rank's whole slice, a join admits whole slices).
There the stacked rows have no counterpart: ``--ckpt-dir`` checkpoints
the run (every :data:`CKPT_EVERY` steps and at its end; the trainer's own
saves) and records the mesh it ended on; ``--resume`` starts a world on
that mesh from that checkpoint (the whole state and the data cursor) and
runs ``--steps`` more with no events; ``--compare --tp N`` holds every
resumed rank's losses and final digest to the uninterrupted run's (the
same script, run to the same final step in one go, without
``--ckpt-dir``) bit for bit.  Each record lists the extent of
every step (``dps``) beside its time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama3.2-1b"
RANKS = 4  # the initial extent: ranks 0-3
LR = 5e-3
CKPT_EVERY = 3  # under the (2, 2) script: a save at (1, 2) and one at (2, 2)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="scripts/elastic_cards.py")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--grad-sync", default="compressed",
                    choices=["compressed", "mrd_zero1", "mrd_paper", "mrd_leaf", "local_sgd",
                             "gspmd"])
    ap.add_argument("--tp", type=int, default=1, help="the model ranks of a data slice")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--bucket-bytes", type=int, default=32 * 2**20)
    ap.add_argument("--kill", action="append", default=None, metavar="STEP:ID")
    ap.add_argument("--join", action="append", default=None, metavar="STEP:ID[,ID...]")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/elastic_cards")
    ap.add_argument("--stacked", action="store_true", help="the stacked-rows trainer")
    ap.add_argument("--compare", action="store_true",
                    help="hold the world to the stacked rows (at --tp > 1: the resumed run "
                         "to the uninterrupted one)")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint the run here")
    ap.add_argument("--resume", action="store_true",
                    help="start from --ckpt-dir's checkpoint on the mesh it was saved at")
    return ap


def record_name(args, part: Optional[str] = None) -> str:
    """The name of a world's records: ``<grad-sync>``, ``_tp<tp>`` at
    ``--tp`` > 1, then ``_ckpt`` for a checkpointed run and ``_resume``
    for a resumed one (``part``, when given, in place of that suffix)."""
    name = args.grad_sync if args.tp == 1 else f"{args.grad_sync}_tp{args.tp}"
    if part is None:
        part = ("_resume" if args.resume else "_ckpt") if args.ckpt_dir else ""
    return name + part


def events_of(args):
    from repro_torch.runtime.chaos import parse_chaos

    if args.resume:
        return None
    return parse_chaos(kill=args.kill or ["2:1"], join=args.join or ["4:1"])


def model_config(args):
    from repro_torch.configs import registry

    cfg = registry.get_smoke_config(ARCH) if args.smoke else registry.get_config(ARCH)
    return cfg if args.layers is None else registry.override(cfg, n_layers=args.layers)


def train_config(args):
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    return step_lib.TrainConfig(
        microbatches=1, remat="full", grad_sync=args.grad_sync,
        monitor=args.grad_sync != "local_sgd",
        monitor_mode="interval", monitor_threshold=1e-6, bucket_bytes=args.bucket_bytes or None,
        optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0))


def rank_view(state, mode: str, pos: int, dp: int, stacked: bool) -> dict:
    """What rank ``pos`` of ``dp`` holds that the world and the stacked rows
    compute alike: the params (``local_sgd``: its replica), its optimizer
    rows (``mrd_leaf``: the replicated trees; ``local_sgd``: its replica's;
    the ZeRO-1 modes: its EF residual, and its master/moment rows if it owns
    a segment, since a non-owner's rows are not updated in a world, where
    the stacked rows update them from stale values nothing reads) and its
    monitor's published value and latch (``local_sgd`` has no monitor)."""
    from repro_torch.distributed.gradsync.mrd_zero1 import zero1_owner_segments
    from repro_torch.runtime.elastic import _rows_of

    if mode == "gspmd":
        return {"params": state["params"], "opt": state["opt"]}
    if mode in ("mrd_leaf", "local_sgd"):
        if mode == "local_sgd" and stacked:
            return {"params": _rows_of(state["params"], pos), "opt": _rows_of(state["opt"], pos)}
        return {"params": state["params"], "opt": state["opt"]}
    owner = mode == "mrd_paper" or zero1_owner_segments(dp)[pos] is not None
    opt = {k: (v[pos] if stacked else v) for k, v in state["opt"].items() if k == "ef" or owner}
    mon = state["monitor"]
    return {"params": state["params"], "opt": opt,
            "monitor": {k: (mon[k][pos] if stacked else mon[k]) for k in ("value", "done")}}


def view_digest(view) -> str:
    from repro_torch.launch.train import state_digest

    if "monitor" not in view:
        return state_digest(view)
    flags = torch.stack([view["monitor"]["value"].float(),
                         view["monitor"]["done"].float()]).cpu().tolist()
    return state_digest(view) + f":{flags}"


def run(args, mesh=None, device=None) -> tuple:
    """The elastic trainer under ``args``' script: on stacked rows (no
    ``mesh``) or as this process's rank of a world whose initial mesh is
    ``mesh``, checkpointed into ``--ckpt-dir`` when given.  Returns
    (trainer, final state, record)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed.gradsync import common
    from repro_torch.kernels.mrd_combine import mrd_combine
    from repro_torch.runtime import ElasticConfig, ElasticTrainer

    device = torch.device(args.device) if device is None else device
    cfg, tcfg = model_config(args), train_config(args)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq, seed=0)

    def pipe(m):
        if m is None or not common.is_world(m):
            return SyntheticPipeline(cfg, dcfg, device)
        return SyntheticPipeline(cfg, dcfg, device, rank=common.mesh_rank(m), dp=common.mesh_dp(m))

    ck = None
    if args.ckpt_dir:
        import torch.distributed as dist

        # one step kept: a full-width gspmd snapshot is 14 bytes a parameter
        ck = Checkpointer(args.ckpt_dir, keep=1, world=(
            dist.get_rank(), dist.get_world_size()) if mesh is not None else None)
    # the saves are the trainer's own, at the end of a run call: each call
    # below is one step, handed the checkpointer every --ckpt-every steps
    tr = ElasticTrainer(mesh if mesh is not None else tuple(range(RANKS)), (cfg, tcfg),
                        pipe, checkpointer=ck, device=device,
                        cfg=ElasticConfig(policy="grow_on_join", ckpt_every=1 << 30))
    state = tr.init_or_restore(torch.Generator(device=device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    events, losses, ms, dps = events_of(args), [], [], []
    launches0 = mrd_combine.launches
    for _ in range(args.steps):  # one step a call, timed (a save ends each call)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        last = len(ms) == args.steps - 1
        tr.ck = ck if (tr.step + 1) % CKPT_EVERY == 0 or last else None
        state, got = tr.run(state, 1, events=events)
        losses += got
        ms.append((time.perf_counter() - t) * 1e3 if tr.member() else None)
        dps.append(tr.dp())
    rec = {"losses": losses, "ms_per_step": ms, "dps": dps, "tp": tr.tp(),
           "start_step": tr.step - args.steps,
           "trajectory": [(e.kind, e.old_dp, e.new_dp, e.step) for e in tr.resizes],
           "device_ids": list(tr.device_ids()), "resize_times": tr.resize_times,
           "mrd_combine_launches": mrd_combine.launches - launches0,
           "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
           else None}
    return tr, state, rec


def world_main(args) -> int:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.gradsync import common
    from repro_torch.launch.train import end_world, start_world, world_env

    env = world_env()
    device = start_world(env, args.device)
    tag = record_name(args)
    try:
        if args.resume:  # the mesh the checkpoint was saved at
            grid = json.loads((Path(args.ckpt_dir) / "mesh.json").read_text())
        else:
            grid = torch.arange(RANKS).reshape(RANKS // args.tp, args.tp).tolist()
        names = ("data",) if args.tp == 1 else ("data", "model")
        shape = (-1,) if args.tp == 1 else (-1, args.tp)
        mesh = DeviceMesh(device.type, torch.tensor(grid).reshape(shape), mesh_dim_names=names)
        tr, state, rec = run(args, mesh, device)
        rank = dist.get_rank()
        if tr.member():
            pos = common.mesh_rank(tr.mesh)
            rec["digest"] = view_digest(rank_view(state, args.grad_sync, pos, tr.dp(), False))
        rec["rank"] = rank
        if args.ckpt_dir and rank == 0:
            (Path(args.ckpt_dir) / "mesh.json").write_text(json.dumps(
                tr.mesh.mesh.reshape(-1, args.tp).tolist()))
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / f"{tag}_rank{rank}.json", "w") as f:
            json.dump(rec, f)
        if rank == 0:
            print(f"world {tag}: trajectory {rec['trajectory']}, extents {rec['dps']}, losses "
                  f"{rec['losses']}, ms a step {rec['ms_per_step']}, resizes "
                  f"{rec['resize_times']}, peak {rec['peak_bytes']}, mrd_combine launches on "
                  f"rank 0 {rec['mrd_combine_launches']}")
    finally:
        end_world()
    return 0


def stacked_main(args) -> int:
    if args.tp > 1:
        raise SystemExit("--stacked: the stacked rows have no model ranks (--tp 1)")
    if args.device == "cpu":
        torch.set_num_threads(1)  # as each world rank runs: the same sums, bit for bit
    tr, state, rec = run(args)
    dp = tr.dp()
    rec["digests"] = {str(w): view_digest(rank_view(state, args.grad_sync, pos, dp, True))
                      for pos, w in enumerate(tr.device_ids())}
    Path(args.out).mkdir(parents=True, exist_ok=True)
    with open(Path(args.out) / f"{args.grad_sync}_stacked.json", "w") as f:
        json.dump(rec, f)
    print(f"stacked {args.grad_sync}: trajectory {rec['trajectory']}, losses {rec['losses']}, "
          f"ms a step {rec['ms_per_step']}, resizes {rec['resize_times']}, peak "
          f"{rec['peak_bytes']}, mrd_combine launches {rec['mrd_combine_launches']}")
    return 0


def compare_resumed(args) -> int:
    """``--compare`` at ``--tp`` > 1: every rank of the resumed run against
    the uninterrupted one: the steps it ran, losses and final digest equal
    bit for bit."""
    out, name = Path(args.out), record_name(args, "_resume")
    paths = sorted(out.glob(f"{name}_rank*.json"))
    ok = bool(paths)
    for path in paths:
        rec = json.load(open(path))
        full = json.load(open(out / f"{record_name(args, '')}_rank{rec['rank']}.json"))
        a = rec["start_step"]
        want = full["losses"][a:a + len(rec["losses"])]
        same = rec["losses"] == want and rec.get("digest") == full.get("digest")
        print(f"{name} rank {rec['rank']}: resumed at step {a}, losses {rec['losses']} against "
              f"{want}, digest equal {rec.get('digest') == full.get('digest')}")
        ok = ok and same
    print(f"{name}: the resumed run equals the uninterrupted run bit for bit: {ok}")
    return 0 if ok else 1


def compare_main(args) -> int:
    if args.tp > 1:
        return compare_resumed(args)
    out = Path(args.out)
    stacked = json.load(open(out / f"{args.grad_sync}_stacked.json"))
    paths = sorted(out.glob(f"{args.grad_sync}_rank*.json"))
    ok = bool(paths)
    for path in paths:
        rec = json.load(open(path))
        live = "digest" in rec
        same_losses = all(a is None or a == b for a, b in zip(rec["losses"], stacked["losses"]))
        same = same_losses and rec["trajectory"] == stacked["trajectory"] and len(
            rec["losses"]) == len(stacked["losses"]) and (
            not live or rec["digest"] == stacked["digests"][str(rec["rank"])])
        print(f"{args.grad_sync} rank {rec['rank']} ({'live' if live else 'outside'}): losses "
              f"equal {same_losses}, digest equal "
              f"{live and rec['digest'] == stacked['digests'][str(rec['rank'])]}, "
              f"mrd_combine launches {rec['mrd_combine_launches']}, peak {rec['peak_bytes']}")
        ok = ok and same
    print(f"{args.grad_sync}: every live rank equals the stacked trainer's row: {ok}")
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.compare:
        return compare_main(args)
    if args.stacked:
        return stacked_main(args)
    return world_main(args)


if __name__ == "__main__":
    sys.exit(main())
