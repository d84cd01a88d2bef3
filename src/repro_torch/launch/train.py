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
train state and the data cursor, at the same ``--dp``), then runs
``--steps`` more steps; it snapshots the state whenever ``--ckpt-every``
steps of this run, or ``--ckpt-every-seconds``, have passed (an async
save: the loop goes on while the writer writes), and once more, blocking,
at the end.  The reference's tensor parallelism, elastic runtime, overlap
and telemetry are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.optim.optimizer import OptimizerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks (rows)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-sync", default="mrd_zero1", choices=step_lib.available_grad_sync())
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=step_lib.REMAT_POLICIES)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "const"])
    ap.add_argument("--monitor-threshold", type=float, default=0.0,
                    help="stop when the staged-MRD-certified loss < threshold")
    ap.add_argument("--monitor-mode", default="inexact",
                    choices=["inexact", "exact", "interval"])
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the EF-SGD residual carry of the 'compressed' mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--bucket-bytes", type=int, default=32 * 2**20,
                    help="cap per gradient bucket (0 = one bucket per dtype)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-every-seconds", type=float, default=None,
                    help="also snapshot whenever this much wall time has passed since the last "
                         "save (whichever of the two fires first)")
    ap.add_argument("--device", default="cuda")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make(args: argparse.Namespace):
    """(device, cfg, train step, data pipeline) for parsed ``args``; the
    train state is ``step.init_state(generator)``."""
    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    tcfg = step_lib.TrainConfig(
        microbatches=args.microbatches,
        remat=args.remat,
        grad_sync=args.grad_sync,
        monitor=args.monitor_threshold > 0,
        monitor_mode=args.monitor_mode,
        monitor_threshold=args.monitor_threshold,
        error_feedback=not args.no_error_feedback,
        bucket_bytes=args.bucket_bytes or None,
        optimizer=OptimizerConfig(lr=args.lr, schedule=args.schedule,
                                  warmup_steps=min(20, args.steps // 10),
                                  total_steps=args.steps),
    )
    train_step = step_lib.make_train_step(cfg, tcfg, dp=args.dp, device=device)
    pipe = SyntheticPipeline(cfg, DataConfig(batch=args.batch, seq_len=args.seq,
                                             seed=args.seed), device)
    return device, cfg, train_step, pipe


def resume(ck: Checkpointer, state, cfg, pipe, dp: int, device):
    """The state of ``ck``'s latest step in place of ``state`` (which the
    restore reads as its template, then lets go), and ``pipe``'s cursor;
    returns (state, the step or None when the directory holds none)."""
    step0 = ck.latest_step()
    if step0 is None:
        return state, None
    template = convert.train_state_to_reference(state)
    restored = ck.restore(step0, template, "cpu", dp=dp)
    del template, state
    state = convert.train_state_from_reference(restored, cfg, device)
    pipe.load_state_dict(ck.manifest(step0)["extra"]["data"])
    return state, step0


def main(argv=None) -> dict:
    """Parse ``argv`` and train.  Returns the run's record: per-step
    ``losses``, ``grad_norms`` and ``ms_per_step``, ``tokens_per_s`` over
    the steps after the first, the step the monitor certified at (or
    None), the moe family's ``aux_losses``, the peak device memory in
    bytes (CUDA), the step resumed from
    (or None), the checkpointer's save records (``ckpt_saves``: step,
    wait_s, hold_s, write_s, bytes) and the final ``state``."""
    args = build_parser().parse_args(argv)
    device, cfg, train_step, pipe = make(args)
    tcfg = train_step.tcfg
    state = train_step.init_state(torch.Generator(device=device).manual_seed(args.seed))
    ck = (Checkpointer(args.ckpt_dir, save_every_steps=args.ckpt_every,
                       save_every_seconds=args.ckpt_every_seconds) if args.ckpt_dir else None)
    rec = {"losses": [], "grad_norms": [], "ms_per_step": [], "converged_at": None,
           "resumed_from": None, "ckpt_saves": []}
    if ck is not None:
        state, rec["resumed_from"] = resume(ck, state, cfg, pipe, args.dp, device)
        if rec["resumed_from"] is not None:
            print(f"resumed from checkpoint step {rec['resumed_from']}")
    print(f"train {cfg.name}{' smoke' if args.smoke else ''} x {args.grad_sync} "
          f"(dp={args.dp}, batch {args.batch} x seq {args.seq}, {device})")

    def snapshot(block):
        # the data cursor is taken in the same instant the leaves are staged
        ck.save(state["step"], convert.train_state_to_reference(state),
                extra={"data": pipe.state_dict(), "dp": args.dp, "grad_sync": args.grad_sync},
                block=block)

    for i in range(args.steps):
        batch = pipe.next_batch()
        _sync(device)
        t = time.perf_counter()
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
            print(f"step {state['step']}: loss={loss:.4f}{aux} gnorm={gnorm:.3f} "
                  f"({ms:.0f} ms/step, {args.batch * args.seq / ms * 1e3:.0f} tokens/s)")
        if ck is not None and ck.should_save(i + 1):
            snapshot(block=False)
        if tcfg.monitor and bool(metrics["converged"]):
            rec["converged_at"] = state["step"]
            print(f"ConvergenceMonitor ({args.monitor_mode}) certified loss "
                  f"{float(metrics['monitor_value']):.4f} < {args.monitor_threshold} at step "
                  f"{state['step']} - stopping.")
            break
    if ck is not None:
        snapshot(block=True)
        rec["ckpt_saves"] = ck.saves
        print("checkpoint saves: " + ", ".join(
            f"step {r['step']} ({r['bytes'] / 2**20:.1f} MiB, held the loop "
            f"{r['hold_s'] * 1e3:.1f} ms, written in {r['write_s'] * 1e3:.1f} ms)"
            for r in ck.saves))
    steady = rec["ms_per_step"][1:] or rec["ms_per_step"]
    rec["tokens_per_s"] = args.batch * args.seq / (sum(steady) / len(steady)) * 1e3
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if rec["peak_bytes"] is not None:
        print(f"peak device memory {rec['peak_bytes'] / 2**30:.3f} GiB")
    print(f"done. final loss: {rec['losses'][-1]:.4f}")
    rec["state"] = state
    return rec


if __name__ == "__main__":
    main()
