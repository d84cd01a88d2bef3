"""Training command line (port of ``repro.launch.train``, the plain loop).

  python -m repro_torch.launch.train --arch llama3.2-1b --steps 4 \\
      --batch 6 --seq 1024 --dp 3 --grad-sync compressed
  python -m repro_torch.launch.train --arch hubert-xlarge --steps 4 \\
      --batch 6 --seq 1024 --dp 3 --grad-sync compressed --remat dots \\
      --ckpt-dir ckpt_hubert --ckpt-every 2

trains the full-width config of any registered arch on the card: random
weights from ``--seed`` drawn on the device, synthetic batches (with the
vision frontend's patches, or the audio encoder's frames and labels),
``--dp`` data-parallel ranks as rows of stacked tensors on one device
(each takes ``batch / dp`` sequences) whose gradients, or for
``local_sgd`` whose replicas, cross by the paper's MRD collectives.
``--smoke`` takes the reduced config.  ``--device`` defaults to ``cuda``
and raises without a card; ``--device cpu`` runs the same code on the CPU,
where the int8 combine is the ``mrd_combine`` kernel's plain version.
With ``--monitor-threshold`` > 0 the ConvergenceMonitor runs, and the loop
stops when it certifies the loss below the threshold.

With ``--ckpt-dir`` the run resumes from the directory's latest step (the
train state and the data cursor, at the same ``--dp`` and ``--tp``), then runs
``--steps`` more steps; it snapshots the state whenever ``--ckpt-every``
steps of this run, or ``--ckpt-every-seconds``, have passed (an async
save: the loop goes on while the writer writes), and once more, blocking,
at the end.  The reference's telemetry is not ported yet.

``--elastic-policy NAME`` (any ``ELASTIC_POLICIES`` entry: ``static``,
``shrink_on_failure``, ``grow_on_join``, ``drain_straggler``, ...) drives
the run through ``runtime.ElasticTrainer`` instead of the plain loop: a
reported failure shrinks the data-parallel extent in place, a joiner grows
it, and the MRD plans keep every extent, non-power-of-two included,
correct.  Like the reference's, the CLI takes no kill or join flags, so it
resizes only when a worker is reported; with ``--ckpt-dir`` the run starts
from the latest checkpoint at any ``--dp`` (params, step and data cursor;
the optimizer restarts from the restored params; at the saved ``--dp`` the
whole state).  Under ``torch.distributed.run`` the world may be larger
than ``--dp`` x ``--tp``: ranks ``0..dp*tp-1`` train, as a ``("data",
"model")`` mesh of ``(--dp, --tp)`` when ``--tp`` > 1, and the rest wait
as spares; every process runs the same controller.  A resize there drops
or admits whole ``"data"`` slices (``--tp`` ranks each), and
``--ckpt-dir`` checkpoints the world as the plain loop's world does.

``--overlap`` (the gradient-scale modes ``mrd_paper``, ``mrd_zero1``,
``compressed`` and ``mrd_leaf``) runs the backward in three segments
(head, layer stack, embeddings) and sends each gradient bucket through
its plan as soon as its segment is done (``gradsync.overlap``): the same
buffers, params and optimizer state as ``--no-overlap`` (the default),
bit for bit; ``gspmd`` and ``local_sgd`` ignore it.

``--grad-sync`` defaults to ``gspmd``, as the reference's: params and
optimizer state placed by ``distributed.sharding`` (FSDP over the data
ranks, TP over ``--tp`` model ranks).  On stacked rows it is the
unsharded full-batch step, and ``--dp`` only splits the monitor's rows.

Under ``torch.distributed.run`` (``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in the environment) the trainer is a world of one process
a rank over a ``DeviceMesh`` (:func:`build_mesh`): ``("data", "model")``
of ``(--dp, --tp)`` when ``--tp`` > 1, else ``("data",)``; NCCL with card
``LOCAL_RANK`` a rank, or gloo with ``--device cpu``; ``--dp`` x ``--tp``
must equal the world size.  Each rank holds its own state and the batch
shard of its ``"data"`` coordinate.  The MRD modes run their gradient
plans on the ``device`` executor (``device_fused`` for ``compressed`` on
the card, whose int8 combine is the ``mrd_combine`` kernel) over the
rank's ``"data"`` column; at ``--tp`` > 1 each rank holds its TP blocks
of every leaf and runs the model's tensor-parallel collectives over its
``"model"`` row (``gradsync.common.ModelRanks``).  Rank 0 logs.  An MRD
world's ranks each write their part of a checkpoint (at ``--tp`` > 1
every part of a rank's state is its own: its blocks of the params and
its optimizer rows); a ``gspmd`` world's are gathered leaf by leaf to
rank 0, which writes the global leaves.

  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-1b --steps 4 --batch 8 --seq 1024 --dp 4 --grad-sync compressed
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-1b --steps 4 --batch 4 --seq 1024 --dp 2 --tp 2
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-1b --steps 4 --batch 4 --seq 1024 --dp 2 --tp 2 \\
      --grad-sync compressed --overlap
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import RESIZE_HINT, flatten_with_paths
from repro_torch.collectives import plans
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import rank_device, resolve_device
from repro_torch.distributed import step as step_lib
from repro_torch.distributed.gradsync.gspmd import restore_global, save_global
from repro_torch.distributed.sharding import MODEL
from repro_torch.kernels.mrd_combine import mrd_combine
from repro_torch.models import convert
from repro_torch.optim.optimizer import OptimizerConfig

DIST_TIMEOUT_S = 600.0  # a world rank that waits longer for another raises instead of hanging


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: rows of stacked tensors on one device, or under "
                         "torch.distributed.run the world size (one process a rank)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel model ranks of a world (any --grad-sync): the mesh "
                         "is (--dp, --tp) over ('data', 'model')")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "lion", "sgd"])
    ap.add_argument("--grad-sync", default="gspmd", choices=step_lib.available_grad_sync())
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=step_lib.REMAT_POLICIES)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "const"])
    ap.add_argument("--monitor-threshold", type=float, default=0.0,
                    help="stop when the staged-MRD-certified loss < threshold")
    ap.add_argument("--monitor-mode", default="inexact",
                    choices=["inexact", "exact", "interval"])
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the EF-SGD residual carry of the 'compressed' mode")
    ap.add_argument("--overlap", action="store_true", default=False,
                    help="ready-bucket grad-sync overlap: issue each gradient bucket's MRD "
                         "stages as its backward segment completes; bit-identical to the "
                         "post-backward path (mrd_paper, mrd_zero1, compressed, mrd_leaf; "
                         "gspmd and local_sgd ignore it)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="post-backward bucketed grad sync (the default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--bucket-bytes", type=int, default=32 * 2**20,
                    help="cap per gradient bucket (0 = one bucket per dtype)")
    ap.add_argument("--elastic-policy", default=None,
                    help="drive training through the elastic runtime with this resize policy "
                         "(any ELASTIC_POLICIES entry: static | shrink_on_failure | "
                         "grow_on_join | drain_straggler); default: the plain train loop")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-every-seconds", type=float, default=None,
                    help="also snapshot whenever this much wall time has passed since the last "
                         "save (whichever of the two fires first)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile the last step on rank 0 (torch.profiler): the plans' runs and, "
                         "on a card, device busy, the plans' device time, mrd_combine's time "
                         "and launches; the other steps give ms/step and tokens/s")
    ap.add_argument("--summary-json", default=None, metavar="PATH",
                    help="write each rank's record (no state) and a digest of its final state "
                         "to PATH, with {rank} replaced by the rank")
    return ap


def world_env() -> Optional[tuple[int, int, int]]:
    """(rank, world size, local rank) from ``torch.distributed.run``'s
    environment, or None outside a world."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    if not all(k in os.environ for k in keys):
        return None
    return tuple(int(os.environ[k]) for k in keys)


def build_mesh(dp: int, tp: int, device_type: str):
    """The world's ``DeviceMesh``, as the reference's ``build_mesh``: axes
    ``("data", "model")`` of ``(dp, tp)`` when ``tp`` > 1, else
    ``("data",)`` of ``(dp,)``; ``dp * tp`` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if dp * tp != world:
        what = "--dp" if tp == 1 else "--dp x --tp"
        raise SystemExit(f"{what} {dp * tp} but the world has {world} ranks: a world runs one "
                         f"rank a process, so {what} must equal WORLD_SIZE")
    if tp > 1:
        return init_device_mesh(device_type, (dp, tp), mesh_dim_names=(step_lib.DATA, MODEL))
    return init_device_mesh(device_type, (dp,), mesh_dim_names=(step_lib.DATA,))


def start_world(env, device: str) -> torch.device:
    """Join the world of ``env`` (rank, world size, local rank): set the
    rank's card and start the process group (NCCL on the card, gloo with
    ``device="cpu"``, never a fallback from one to the other) with its
    timeout.  Returns the rank's device."""
    rank, world, local = env
    device = rank_device(local, device,
                         local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S), **kw)
    return device


def teardown_order() -> list:
    """The process groups this process holds, in the order :func:`end_world`
    shuts them down: the newest first, the default group last."""
    from torch.distributed import distributed_c10d as c10d

    default = c10d._get_default_group()
    return [pg for pg in reversed(list(c10d._world.pg_names)) if pg is not default] + [default]


def end_world() -> None:
    """Leave the world :func:`start_world` joined: each process group this
    process holds is shut down in the reverse order of its making, one
    at a time, the default group last.  On NCCL a communicator's shutdown
    may wait for its other members, and ``destroy_process_group()`` alone
    takes the groups sorted by name.  A group split off the default one
    is named after its ranks and the count of groups its maker holds.  A
    rank outside an elastic mesh holds none of its groups, so after a
    shrink and a grow two members of one group can name it apart, sort
    it at different places and each wait in a group the other has not
    reached.  The order of making is the same on every member: every
    process builds every mesh, in the same order."""
    for pg in teardown_order():
        dist.destroy_process_group(pg)


def init_world(args, env) -> tuple:
    """Join the world of ``env`` (:func:`start_world` on ``args.device``)
    and build its mesh of ``(--dp, --tp)`` (:func:`build_mesh`).  Returns
    (device, mesh)."""
    device = start_world(env, args.device)
    return device, build_mesh(args.dp, getattr(args, "tp", 1), device.type)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def configs(args: argparse.Namespace) -> tuple:
    """(model config, TrainConfig) of parsed ``args``."""
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    tcfg = step_lib.TrainConfig(
        microbatches=args.microbatches,
        remat=args.remat,
        grad_sync=args.grad_sync,
        monitor=args.monitor_threshold > 0,
        monitor_mode=args.monitor_mode,
        monitor_threshold=args.monitor_threshold,
        error_feedback=not args.no_error_feedback,
        overlap=getattr(args, "overlap", False),
        bucket_bytes=args.bucket_bytes or None,
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr, schedule=args.schedule,
                                  warmup_steps=min(20, args.steps // 10),
                                  total_steps=args.steps),
    )
    return cfg, tcfg


def make(args: argparse.Namespace, device=None, mesh=None):
    """(device, cfg, train step, data pipeline) for parsed ``args``; the
    train state is ``step.init_state(generator)``.  In a world (``mesh``)
    the step is this rank's and the pipeline yields its batch shard."""
    device = resolve_device(args.device if device is None else device)
    cfg, tcfg = configs(args)
    train_step = step_lib.make_train_step(cfg, tcfg, dp=args.dp, device=device, mesh=mesh)
    rank = 0 if mesh is None else step_lib.world_rank(mesh)[0]
    pipe = SyntheticPipeline(cfg, DataConfig(batch=args.batch, seq_len=args.seq,
                                             seed=args.seed), device,
                             rank=rank, dp=1 if mesh is None else args.dp)
    return device, cfg, train_step, pipe


def to_reference(state, ck: Checkpointer, grad_sync: str, tp: int = 1) -> tuple:
    """(the state as the reference nests it, the parts of it that are this
    rank's rows): a world rank's own part, or the stacked rows whole.  At
    ``tp`` > 1 every part but the step is the rank's own (its blocks of
    the params and its optimizer rows over its local layout), saved as
    its row of ``[dp x tp, ...]`` leaves."""
    if ck.world:
        tree, rows = convert.rank_state_to_reference(state, replica=grad_sync == "local_sgd")
        if tp > 1:
            rows = tuple(k for k in tree if k != "step")
        return tree, rows
    return convert.train_state_to_reference(state), ()


def gspmd_world(train_step, mesh) -> bool:
    """Is this a ``gspmd`` world (whose checkpoints are global leaves)?"""
    return mesh is not None and train_step.tcfg.grad_sync == "gspmd"


def resume(ck: Checkpointer, state, cfg, pipe, dp: int, device, grad_sync: str,
           train_step=None, mesh=None, tp: int = 1):
    """The state of ``ck``'s latest step in place of ``state`` (which the
    restore reads as its template, then lets go), and ``pipe``'s cursor;
    returns (state, the step or None when the directory holds none).  The
    plain loop resumes the whole state, so a checkpoint of another ``--dp``
    or ``--tp`` is refused; ``--elastic-policy`` restores one of another
    ``--dp`` (``ElasticTrainer.init_or_restore``: params, step and cursor,
    the optimizer restarted from the params)."""
    step0 = ck.latest_step()
    if step0 is None:
        return state, None
    saved_tp = ck.manifest(step0)["extra"].get("tp", 1)
    if saved_tp != tp:
        raise ValueError(f"checkpoint step {step0} was saved at tp={saved_tp}, this run has "
                         f"tp={tp}: {RESIZE_HINT}")
    if train_step is not None and gspmd_world(train_step, mesh):
        del state
        state = restore_global(ck, step0, train_step, device)
        pipe.load_state_dict(ck.manifest(step0)["extra"]["data"])
        return state, step0
    template, rows = to_reference(state, ck, grad_sync, tp)
    if ck.world:
        restored = ck.restore_rank(step0, template, rows, "cpu", dp=dp)
        del template, state
        state = convert.rank_state_from_reference(restored, cfg, device)
    else:
        restored = ck.restore(step0, template, "cpu", dp=dp)
        del template, state
        state = convert.train_state_from_reference(restored, cfg, device)
    pipe.load_state_dict(ck.manifest(step0)["extra"]["data"])
    return state, step0


def profile_step(run, device) -> dict:
    """Run ``run()`` (one train step, waited on) under ``torch.profiler``:
    the step's wall ms (profiler included), the blocking plan runs
    (``plans.PROFILE_RANGE``: the gradient sync, its scalars, the logged
    loss) and, on a card, the device busy ms (every kernel, NCCL's
    included), the device ms of the kernels launched inside the plans,
    the device ms of every NCCL kernel (the step's collectives: a
    ``gspmd`` step's DP and TP reductions, gathers and all-to-alls) and
    its share of the busy time, the ms in which an NCCL kernel ran
    while another kernel did (``collective_concurrent_ms``: the
    collectives hidden behind compute, what ``--overlap`` is for), and
    ``mrd_combine``'s device ms and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        run()
        _sync(device)
    wall = (time.perf_counter() - t) * 1e3
    events = prof.events()
    ranges = [e for e in events
              if e.name == plans.PROFILE_RANGE and e.device_type == DeviceType.CPU]
    out = {"wall_ms": wall, "plan_runs": len(ranges)}
    if cuda:
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        combine = [e for e in kernels if "mrd_combine" in e.name]
        busy = sum(e.device_time_total for e in kernels) / 1e3
        plan_ms = sum(e.device_time_total for e in ranges) / 1e3
        nccl_ms = sum(e.device_time_total for e in kernels if "nccl" in e.name.lower()) / 1e3
        nccl = [e for e in kernels if "nccl" in e.name.lower()]
        other = [e for e in kernels if "nccl" not in e.name.lower()]
        out.update(busy_ms=busy, plan_ms=plan_ms, plan_share=plan_ms / busy if busy else None,
                   collective_ms=nccl_ms, collective_share=nccl_ms / busy if busy else None,
                   collective_concurrent_ms=_overlap_us(nccl, other) / 1e3,
                   mrd_combine_ms=sum(e.device_time_total for e in combine) / 1e3,
                   mrd_combine_launches=len(combine))
    return out


def _merged(events) -> list:
    """The union of the events' device time ranges, as sorted disjoint
    (start, end) pairs in us."""
    out: list = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(xs, ys) -> float:
    """The us in which an event of ``xs`` and one of ``ys`` both ran."""
    a, b = _merged(xs), _merged(ys)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


DIGEST_PIECE = 1 << 24  # 32-bit words a piece of the digest


def state_digest(state) -> str:
    """A fingerprint of a train state's bytes: for each params and
    optimizer leaf (the reference's key paths, so stacked rows at dp 1 and
    a world rank's rows give the same one), the wrapping int64 sums of its
    32-bit words (16-bit for a 2-byte leaf, 8-bit for a 1-byte one) and of
    the words times their place.  Computed on the leaf's device in pieces;
    integer sums wrap and do not depend on the order of the reduction, so
    equal bytes give equal digests on any device."""
    tree = {"params": convert.reference_tree(state["params"]),
            "opt": {k: convert.reference_tree(v) if isinstance(v, dict) else v
                    for k, v in state["opt"].items()}}
    parts = []
    for key, leaf in sorted(flatten_with_paths(tree).items()):
        flat = leaf.detach().contiguous().reshape(-1)
        words = flat.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[flat.element_size()])
        s1 = s2 = 0
        place = torch.arange(1, DIGEST_PIECE + 1, dtype=torch.int64, device=flat.device)
        for i, a in enumerate(range(0, words.numel(), DIGEST_PIECE)):
            w = words[a:a + DIGEST_PIECE].to(torch.int64)
            s1 += int(w.sum())
            s2 += (i + 1) * int((w * place[:w.numel()]).sum())
        parts.append(f"{key}:{s1 & (2**64 - 1):x}:{s2 & (2**64 - 1):x}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def main(argv=None) -> dict:
    """Parse ``argv`` and train.  Returns the run's record: per-step
    ``losses``, ``grad_norms`` and ``ms_per_step``, ``tokens_per_s`` over
    the steps after the first, the step the monitor certified at (or
    None), the moe family's ``aux_losses``, the ``rank`` and
    ``world_size`` (0 and 1 outside a world), the peak memory of the
    rank's device in bytes (CUDA), ``mrd_combine``'s launches in the loop,
    the step resumed from (or None), the checkpointer's save records
    (``ckpt_saves``: step, wait_s, hold_s, write_s, bytes) and the final
    ``state``."""
    args = build_parser().parse_args(argv)
    env = world_env()
    if args.elastic_policy is not None:
        return elastic_main(args, env)
    if env is None:
        if args.tp > 1:
            raise SystemExit(f"--tp {args.tp} needs a world of --dp x --tp = {args.dp * args.tp} "
                             f"ranks (python -m torch.distributed.run --nproc-per-node "
                             f"{args.dp * args.tp} ...)")
        return train(args)
    device, mesh = init_world(args, env)
    try:
        return train(args, device, mesh)
    finally:
        end_world()


def elastic_main(args, env) -> dict:
    """``--elastic-policy``: :func:`elastic_train` on stacked rows, or in
    the world of ``env`` over the initial ranks ``0..dp*tp-1`` (a
    ``("data", "model")`` mesh at ``--tp`` > 1; the rest of the world
    spares)."""
    from repro_torch.runtime import get_policy

    get_policy(args.elastic_policy)  # fail fast on an unknown name
    if env is None:
        if args.tp > 1:
            raise SystemExit(f"--tp {args.tp} needs a world of at least --dp x --tp = "
                             f"{args.dp * args.tp} ranks (python -m torch.distributed.run "
                             f"--nproc-per-node {args.dp * args.tp} ...)")
        return elastic_train(args)
    from torch.distributed.device_mesh import DeviceMesh

    device = start_world(env, args.device)
    try:
        n = args.dp * args.tp
        if n > dist.get_world_size():
            what = "--dp" if args.tp == 1 else "--dp x --tp"
            raise SystemExit(f"{what} {n} but the world has {dist.get_world_size()} ranks")
        if args.tp > 1:
            mesh = DeviceMesh(device.type, torch.arange(n).reshape(args.dp, args.tp),
                              mesh_dim_names=(step_lib.DATA, MODEL))
        else:
            mesh = DeviceMesh(device.type, list(range(n)), mesh_dim_names=(step_lib.DATA,))
        return elastic_train(args, device, mesh)
    finally:
        end_world()


def elastic_train(args, device=None, mesh=None) -> dict:
    """The run of :func:`main` through ``runtime.ElasticTrainer`` (the
    reference CLI's ``--elastic-policy`` path): stacked rows of replica ids
    ``0..dp-1`` on one device, or this process of a world whose initial
    mesh is ``mesh``.  Returns ``losses`` (None for a step a world process
    sat out), the ``resizes``, the checkpoint ``restores``, the ``rank``
    and ``world_size`` and the final ``state``."""
    from repro_torch.distributed.gradsync import common
    from repro_torch.runtime import ElasticConfig, ElasticTrainer

    device = resolve_device(args.device if device is None else device)
    cfg, tcfg = configs(args)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq, seed=args.seed)
    rank, world = (0, 1) if mesh is None else (dist.get_rank(), dist.get_world_size())
    say = print if rank == 0 else (lambda *a, **k: None)

    def pipe(m):
        if not common.is_world(m):
            return SyntheticPipeline(cfg, dcfg, device)
        return SyntheticPipeline(cfg, dcfg, device, rank=common.mesh_rank(m), dp=common.mesh_dp(m))

    # in a world the trainer binds each save to the current mesh; the
    # world's rank 0 alone sweeps stale temporaries at the start
    ck = (Checkpointer(args.ckpt_dir, save_every_steps=args.ckpt_every,
                       save_every_seconds=args.ckpt_every_seconds,
                       world=None if mesh is None else (rank, world))
          if args.ckpt_dir else None)
    trainer = ElasticTrainer(tuple(range(args.dp)) if mesh is None else mesh, (cfg, tcfg), pipe,
                             checkpointer=ck, device=device,
                             cfg=ElasticConfig(ckpt_every=args.ckpt_every,
                                               policy=args.elastic_policy))
    state = trainer.init_or_restore(torch.Generator(device=device).manual_seed(args.seed))
    say(f"train {cfg.name}{' smoke' if args.smoke else ''} x {args.grad_sync} elastic "
        f"({args.elastic_policy}, dp={args.dp}"
        + ("" if mesh is None else f" x tp={args.tp} of a world of {world}")
        + f", batch {args.batch} x seq {args.seq}, {device}) from step {trainer.step}")
    state, losses = trainer.run(state, args.steps)
    last = losses[-1] if losses else None
    say(f"done ({len(trainer.resizes)} resizes, {trainer.restores} checkpoint restores). "
        f"final loss: {'n/a' if last is None else f'{last:.4f}'}")
    return {"losses": losses, "resizes": trainer.resizes, "restores": trainer.restores,
            "resize_times": trainer.resize_times, "rank": rank, "world_size": world,
            "state": state}


def train(args, device=None, mesh=None) -> dict:
    """The training loop of :func:`main`: stacked rows on one device, or
    with ``mesh`` this process's rank of a world."""
    device, cfg, train_step, pipe = make(args, device, mesh)
    rank, world = (0, 1) if mesh is None else (dist.get_rank(), dist.get_world_size())
    say = print if rank == 0 else (lambda *a, **k: None)
    tcfg = train_step.tcfg
    tp = getattr(args, "tp", 1)
    state = train_step.init_state(torch.Generator(device=device).manual_seed(args.seed))
    global_leaves = gspmd_world(train_step, mesh)
    ck = (Checkpointer(args.ckpt_dir, save_every_steps=args.ckpt_every,
                       save_every_seconds=args.ckpt_every_seconds,
                       world=None if mesh is None or global_leaves else (rank, world))
          if args.ckpt_dir else None)
    rec = {"losses": [], "grad_norms": [], "ms_per_step": [], "converged_at": None,
           "resumed_from": None, "ckpt_saves": [], "rank": rank, "world_size": world}
    if ck is not None:
        state, rec["resumed_from"] = resume(ck, state, cfg, pipe, args.dp, device,
                                            args.grad_sync, train_step, mesh, tp)
        if rec["resumed_from"] is not None:
            say(f"resumed from checkpoint step {rec['resumed_from']}")
    layout = (f"dp={args.dp}" if mesh is None else
              f"a world of {world} ranks, dp={args.dp} x tp={tp}")
    say(f"train {cfg.name}{' smoke' if args.smoke else ''} x {args.grad_sync} "
        f"({layout}, batch {args.batch} x seq {args.seq}, {device}, {args.optimizer})")

    def snapshot(block):
        # the data cursor is taken in the same instant the leaves are staged
        extra = {"data": pipe.state_dict(), "dp": args.dp, "tp": tp,
                 "grad_sync": args.grad_sync}
        if global_leaves:
            return save_global(ck, state, train_step, extra)
        tree, rows = to_reference(state, ck, args.grad_sync, tp)
        ck.save(state["step"], tree, extra=extra, block=block, rows=rows)

    launches0 = mrd_combine.launches
    for i in range(args.steps):
        batch = pipe.next_batch()
        _sync(device)
        t = time.perf_counter()
        if args.profile and i == args.steps - 1 and rank == 0:
            box = {}

            def run():
                box["out"] = train_step(state, batch)

            rec["profile"] = profile_step(run, device)
            state, metrics = box.pop("out")
            say("profiled step: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                                               f"{k} {v}" for k, v in rec["profile"].items()))
        else:
            state, metrics = train_step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # waits for the step
        ms = (time.perf_counter() - t) * 1e3
        rec["losses"].append(loss)
        rec["grad_norms"].append(gnorm)
        if "aux_loss" in metrics:  # the moe family's load-balance loss
            rec.setdefault("aux_losses", []).append(float(metrics["aux_loss"]))
        rec["ms_per_step"].append(ms)
        if (i + 1) % args.log_every == 0 or i == 0:
            aux = f" aux={rec['aux_losses'][-1]:.4f}" if "aux_losses" in rec else ""
            say(f"step {state['step']}: loss={loss:.4f}{aux} gnorm={gnorm:.3f} "
                f"({ms:.0f} ms/step, {args.batch * args.seq / ms * 1e3:.0f} tokens/s)")
        if ck is not None and ck.should_save(i + 1):
            snapshot(block=False)
        if tcfg.monitor and bool(metrics["converged"]):
            rec["converged_at"] = state["step"]
            say(f"ConvergenceMonitor ({args.monitor_mode}) certified loss "
                f"{float(metrics['monitor_value']):.4f} < {args.monitor_threshold} at step "
                f"{state['step']} - stopping.")
            break
    rec["mrd_combine_launches"] = mrd_combine.launches - launches0
    if ck is not None:
        snapshot(block=True)
        rec["ckpt_saves"] = ck.saves
        say("checkpoint saves: " + ", ".join(
            f"step {r['step']} ({r['bytes'] / 2**20:.1f} MiB, held the loop "
            f"{r['hold_s'] * 1e3:.1f} ms, written in {r['write_s'] * 1e3:.1f} ms)"
            for r in ck.saves))
    timed = rec["ms_per_step"][:-1] if args.profile else rec["ms_per_step"]
    steady = timed[1:] or timed or rec["ms_per_step"]
    rec["tokens_per_s"] = args.batch * args.seq / (sum(steady) / len(steady)) * 1e3
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if rec["peak_bytes"] is not None:
        say(f"peak device memory {rec['peak_bytes'] / 2**30:.3f} GiB"
            + ("" if mesh is None else " (rank 0's card)"))
    say(f"done. final loss: {rec['losses'][-1]:.4f}")
    if args.summary_json:
        with open(args.summary_json.format(rank=rank), "w") as f:
            json.dump({**rec, "state_digest": state_digest(state)}, f)
    rec["state"] = state
    return rec


if __name__ == "__main__":
    main()
