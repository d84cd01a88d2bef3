"""Serving command line (port of ``repro.launch.serve``): the static batch
path, or continuous batching with ``--continuous``.

  # static: one timed cached prefill of --batch random prompts, then --gen
  # greedy decode steps
  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 8 \\
      --prompt-len 512 --gen 64
  python -m repro_torch.launch.serve --arch llama3.2-1b --continuous \\
      --workload llm_decode_paged --attn kernel --dp 3 --slots 8 \\
      --requests 16 --prompt-len 64 --gen 32 --block-size 16
  python -m repro_torch.launch.serve --arch gemma3-12b --continuous \\
      --workload llm_decode --dp 3 --slots 4 --requests 8 \\
      --min-prompt-len 1024 --prompt-len 8192 --gen 32
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --continuous \\
      --workload llm_decode --dp 3 --slots 8 --requests 16 \\
      --min-prompt-len 1024 --prompt-len 8192 --gen 64 --max-len 8320
  python -m repro_torch.launch.serve --arch zamba2-2.7b --continuous \\
      --workload llm_decode_paged --dp 3 --slots 8 --requests 16 \\
      --min-prompt-len 1024 --prompt-len 4096 --gen 64 --max-len 4160 --block-size 16
  # per-request fixed-point solves (D-iteration / personalized PageRank),
  # each retired when the paper's detection protocol, agreed across --dp
  # replicas, certifies its residual below --eps; --gen is the iteration
  # budget
  python -m repro_torch.launch.serve --continuous --workload fixedpoint_solve \\
      --solver d_iteration --n 32760 --dp 5 --slots 16 --requests 64 \\
      --eps 1e-10 --gen 400 --termination residual_interval
  # named tenants with TTFT SLAs, priorities and admission quotas, bursty
  # arrivals
  python -m repro_torch.launch.serve --arch llama3.2-1b --continuous \\
      --workload llm_decode_paged --slots 8 --requests 32 --scheduler sla_edf \\
      --tenants "chat:3:sla=8:prio=2,batch:1:quota=4:gen=24" \\
      --arrival bursty:0.2,2.0
  # elastic serving: kill and join agreement replicas under live traffic
  # (extent 4 -> 3 -> 5 -> 4), no request lost, no slot prefilled again
  python -m repro_torch.launch.serve --arch llama3.2-1b --continuous \\
      --slots 8 --requests 24 --arrival poisson:0.5 --dp 4 \\
      --elastic-policy grow_on_join --steps-per-dispatch 4 \\
      --kill 6:2 --stall 10:1 --join 16:4,5 --unstall 22:1 --kill 26:0
  # SLA autoscaling: each replica funds --slots-per-replica slots, and the
  # sla_autoscale policy grows under queue/SLA pressure and shrinks when idle
  python -m repro_torch.launch.serve --arch llama3.2-1b --continuous \\
      --slots 8 --requests 32 --scheduler sla_edf \\
      --tenants "chat:3:sla=8:prio=2,batch:1:quota=4:gen=24" \\
      --arrival bursty:0.2,2.0 --dp 2 --slots-per-replica 4 \\
      --autoscale --max-extent 4 --steps-per-dispatch 4

An LLM workload serves the full-width config of ``--arch`` with random
bf16 weights made from ``--seed`` on the card; ``--smoke`` takes the
reduced config.  ``llm_decode`` keeps a contiguous cache per slot (rolling
local windows and the mamba1 state included); ``llm_decode_paged`` a
block-paged one (attention caches without a rolling window, and zamba2's
shared-block caches beside each slot's mamba2 state).  Every admission
prefills its prompt in one causal forward (on the card: the
flash-attention kernel, or one selective-scan kernel launch a mamba1
layer, or one SSD scan a mamba2 layer); a mamba1 decode tick runs the
same kernel one step from the slot's state.  ``fixedpoint_solve`` needs no ``--arch``: its requests are
payloads of ``--n`` elements (rounded up to a multiple of ``--dp``) for the
``--solver`` operator, queued as the reference CLI queues them at the same
seed.  ``--dp`` replicas are simulated: they agree on every retirement
through the MRD plan, as the reference's continuous path does.  Requests
arrive at the ticks ``--arrival`` draws from ``--seed + 7``; with
``--tenants`` they are the traffic model's (``serving/tenants.py``) at
that seed, and tenant quotas bound admission.  ``--device`` defaults to
``cuda`` and raises when there is no card; ``--device cpu`` runs on the
CPU, where every kernel is its plain PyTorch version.

Elastic serving: ``--elastic-policy`` (an ``ELASTIC_POLICIES`` entry),
``--autoscale`` (``sla_autoscale`` within ``--min-extent`` ..
``--max-extent``) or any chaos flag (``--kill TICK:REPLICA[:silent]``,
``--join TICK:ID[,ID...]``, ``--stall TICK:REPLICA[:FACTOR]``,
``--unstall TICK:REPLICA``) serves through an
:class:`~repro_torch.runtime.ElasticServeController`, which resizes the
``--dp`` agreement extent under live traffic; the events fire at the
first dispatch boundary at or after their tick, and each resize prints a
``# resize:`` line.  ``--slots-per-replica`` funds that many slots a
replica.  ``--telemetry`` is not ported yet.

``--tp`` runs the model tensor-parallel over a world of one process a
rank, under ``torch.distributed.run``, with the mesh the reference's
implies: ``("data", "model")`` of ``(1, tp)`` for ``--continuous`` (the
``--dp`` replicas stay simulated) and ``(dp, tp)`` for the static path
(each data rank serves its shard of the batch).  NCCL with card
``LOCAL_RANK`` a rank, gloo with ``--device cpu``.  Every rank runs the
same host-side engine on the same requests and takes the same greedy
token from the logits gathered over ``"model"``, so admissions and
retirements agree; rank 0 alone prints.  ``fixedpoint_solve`` ignores
``--tp``, as the reference's.

  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch qwen2.5-32b --continuous --workload llm_decode_paged --tp 4 \\
      --slots 8 --requests 16 --prompt-len 512 --gen 64
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.distributed import serve as dserve
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as step_lib
from repro_torch.models import transformer
from repro_torch.runtime import ElasticServeController, SlaAutoscalePolicy
from repro_torch.runtime.chaos import Kill, parse_chaos, scripted_extents
from repro_torch.serving import (
    SCHEDULERS,
    TERMINATION,
    WORKLOADS,
    Request,
    ServeConfig,
    ServeEngine,
    build_requests,
    get_scheduler,
    make_arrival_ticks,
    make_workload,
    parse_tenant_specs,
    quotas_of,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=registry.list_archs(),
                    help="model arch (required unless --workload fixedpoint_solve)")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=4, help="static batch size")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching ServeEngine")
    ap.add_argument("--workload", default="llm_decode_paged", choices=sorted(WORKLOADS))
    ap.add_argument("--attn", default="kernel", choices=("kernel", "gather"),
                    help="paged decode attention: the CUDA kernel reading K/V "
                         "through the block table, or gathered contiguous views")
    ap.add_argument("--scheduler", default="fcfs",
                    help=f"a SCHEDULERS entry ({' | '.join(sorted(SCHEDULERS))}), "
                         "optionally parameterized (sla_edf:MAX_WAIT)")
    ap.add_argument("--termination", default=None, choices=sorted(TERMINATION),
                    help="default: eos_maxlen (LLM) / residual_interval (fixed point)")
    ap.add_argument("--dp", type=int, default=1,
                    help="termination-agreement replicas (MRD over [dp])")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel model ranks: a world of --tp ranks (--continuous) or "
                         "--dp x --tp (the static path) under torch.distributed.run")
    ap.add_argument("--slots", type=int, default=4, help="decode pool slots")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival", default="none",
                    help="none | poisson:RATE (req/tick) | bursty:BASE,PEAK[,RATE,LEN] | "
                         "diurnal:PEAK,PERIOD[,FLOOR] | trace:FILE (JSON ticks)")
    ap.add_argument("--tenants", default=None,
                    metavar="NAME:WEIGHT[:sla=..][:prio=..][:quota=..][:gen=..],...",
                    help="multi-tenant traffic model (serving/tenants.py): requests are "
                         "drawn per tenant, quotas bound admission")
    ap.add_argument("--prompt-len", type=int, default=16, help="longest prompt")
    ap.add_argument("--min-prompt-len", type=int, default=1, help="shortest prompt")
    ap.add_argument("--gen", type=int, default=None,
                    help="largest generation budget (LLM, default 32) or iteration "
                         "budget (fixed point, default 1000)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="pool cache length (0 = prompt+gen+4, rounded up to blocks "
                         "when paged)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="tokens per cache block (llm_decode_paged)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="physical blocks (llm_decode_paged; 0 = contiguous-capacity parity)")
    ap.add_argument("--solver", default="d_iteration",
                    help="fixedpoint_solve: d_iteration | poisson1d | jacobi_dense")
    ap.add_argument("--n", type=int, default=64, help="fixedpoint_solve: problem size")
    ap.add_argument("--eps", type=float, default=1e-6,
                    help="residual terminations: the requests' threshold")
    ap.add_argument("--steps-per-dispatch", type=int, default=16,
                    help="ticks an engine step runs at most (it ends at the first "
                         "retirement and never passes the next arrival)")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="requeues granted to a request forced at cache capacity")
    # elastic serving: resize the agreement extent under live traffic
    ap.add_argument("--elastic-policy", default=None,
                    help="serve through an ElasticServeController (an ELASTIC_POLICIES "
                         "entry, e.g. grow_on_join)")
    ap.add_argument("--min-extent", type=int, default=1,
                    help="never shrink below this many replicas")
    ap.add_argument("--autoscale", action="store_true",
                    help="the sla_autoscale policy: queue/SLA pressure grows, idle shrinks")
    ap.add_argument("--max-extent", type=int, default=8,
                    help="autoscaler: never grow beyond this many replicas")
    ap.add_argument("--slots-per-replica", type=int, default=0,
                    help="capacity model: each replica funds this many slots, so a resize "
                         "changes admission capacity (0 = every slot at any extent)")
    ap.add_argument("--kill", action="append", metavar="TICK:REPLICA[:silent]",
                    help="kill a replica at TICK (repeatable); ':silent' waits for the "
                         "virtual heartbeat timeout")
    ap.add_argument("--join", action="append", metavar="TICK:ID[,ID...]",
                    help="replicas ask to join at TICK (repeatable)")
    ap.add_argument("--stall", action="append", metavar="TICK:REPLICA[:FACTOR]",
                    help="slow a replica's heartbeat step time (repeatable)")
    ap.add_argument("--unstall", action="append", metavar="TICK:REPLICA")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--summary-json", default=None, metavar="PATH",
                    help="write each rank's record (the summary, every request's tokens and "
                         "ticks, the peak device memory, the kernels' launches) to PATH, with "
                         "{rank} replaced by the rank")
    return ap


def arrival_ticks(spec: str, n: int, seed: int) -> list[int]:
    """``make_arrival_ticks`` with a spec error as a CLI exit."""
    try:
        return make_arrival_ticks(spec, n, seed)
    except (ValueError, OSError) as e:
        raise SystemExit(f"--arrival {spec!r}: {e}")


def make_requests(cfg, n: int, prompt_len: int, gen: int, seed: int,
                  min_prompt_len: int = 1, arrivals=None) -> list[Request]:
    """``n`` requests arriving at ``arrivals`` (default: all at tick 0):
    prompt lengths uniform in [min_prompt_len, prompt_len], budgets uniform
    in [gen/2, gen].  With ``min_prompt_len`` 1 the draws follow the
    reference CLI's stream at the same ``seed`` (a priority in [0, 3) and
    an SLA in [4, 64) ticks too), so both queue the same requests."""
    rng = np.random.default_rng(seed)
    arrivals = [0] * n if arrivals is None else arrivals
    reqs = []
    for i in range(n):
        plen = int(rng.integers(min_prompt_len, prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        max_new = int(rng.integers(max(1, gen // 2), gen + 1))
        reqs.append(Request(id=i, arrival=arrivals[i], prompt=prompt, max_new=max_new,
                            priority=int(rng.integers(0, 3)), sla=int(rng.integers(4, 64))))
    return reqs


def make_fixedpoint_requests(n_req: int, n: int, gen: int, seed: int,
                             arrivals=None) -> list[Request]:
    """``n_req`` fixed-point requests arriving at ``arrivals`` (default:
    all at tick 0), each a payload ``rng.random(n)`` normalized to sum 1
    with iteration budget ``gen``, a priority and an SLA in [50, 500): the
    reference CLI's stream at the same ``seed``, so both queue the same
    payloads."""
    rng = np.random.default_rng(seed)
    arrivals = [0] * n_req if arrivals is None else arrivals
    reqs = []
    for i in range(n_req):
        v = rng.random(n).astype(np.float32)
        reqs.append(Request(id=i, arrival=arrivals[i], payload=v / v.sum(), max_new=gen,
                            priority=int(rng.integers(0, 3)), sla=int(rng.integers(50, 500))))
    return reqs


def _serve_fixedpoint(args, device):
    n = -(-args.n // args.dp) * args.dp  # dp-block divisible
    if n != args.n:
        print(f"# rounding --n {args.n} up to {n} (divisible by dp={args.dp})")
    args.n, args.gen = n, args.gen or 1000
    wl = make_workload("fixedpoint_solve", solver=args.solver, n=n, slots=args.slots,
                       dp=args.dp, device=device)
    reqs = None
    if not args.tenants:
        reqs = make_fixedpoint_requests(args.requests, n, args.gen, args.seed,
                                        arrival_ticks(args.arrival, args.requests, args.seed + 7))
    return wl, reqs


def serve(args: argparse.Namespace, mesh=None):
    """Build the workload and engine from parsed ``args`` (``--continuous``)
    and serve ``--requests`` requests -> (engine, workload, results).
    With ``mesh`` (a TP world) the model runs on this rank's part."""
    try:
        get_scheduler(args.scheduler)
    except ValueError as e:
        raise SystemExit(str(e))
    device = resolve_device(args.device)
    if args.workload == "fixedpoint_solve":
        wl, reqs = _serve_fixedpoint(args, device)
    else:
        wl, reqs = _serve_llm(args, device, mesh)
    quotas = None
    if args.tenants:
        try:
            tenants = parse_tenant_specs(args.tenants)
        except ValueError as e:
            raise SystemExit(f"--tenants: {e}")
        # one engine: every tenant targets the deployed --workload
        tenants = tuple(dataclasses.replace(t, workload=args.workload) for t in tenants)
        reqs = build_requests(tenants, {args.workload: wl}, args.requests, args.arrival,
                              args.seed + 7)[args.workload]
        quotas = quotas_of(tenants)
    eng = ServeEngine(wl, ServeConfig(
        scheduler=args.scheduler, termination=args.termination or wl.default_termination,
        dp=args.dp, eps=args.eps, max_retries=args.max_retries,
        steps_per_dispatch=args.steps_per_dispatch, quotas=quotas,
        slots_per_replica=args.slots_per_replica or None,
    ))
    script = parse_chaos(args.kill, args.join, args.stall, args.unstall, log=print)
    if not (args.autoscale or args.elastic_policy or script is not None):
        return eng, wl, eng.run(reqs)
    if script is not None and args.workload == "fixedpoint_solve":
        # refuse at the start an extent the residual's blocks cannot take
        for ev, extent in scripted_extents(script, range(args.dp), args.min_extent):
            if args.n % extent:
                kind = "kill" if isinstance(ev, Kill) else "join"
                raise SystemExit(
                    f"--n {args.n}: the chaos script's {kind} at tick {ev.step} leaves "
                    f"{extent} replicas, and fixedpoint_solve's residual needs n divisible by "
                    f"every extent (n={args.n} does not split into {extent} blocks)")
    policy = args.elastic_policy or "grow_on_join"
    if args.autoscale:
        policy = SlaAutoscalePolicy(min_extent=args.min_extent, max_extent=args.max_extent)
    ctl = ElasticServeController(eng, policy=policy, min_extent=args.min_extent, log=print)
    res = ctl.run(reqs, events=script)
    for ev in ctl.resizes:
        print(f"# resize: {ev.kind} {ev.old_dp} -> {ev.new_dp} @tick {ev.step} ({ev.reason})")
    return eng, wl, res


def _llm_config(args):
    """The served arch's config (``--gen`` defaults to 32 for it); an
    encoder-only arch is refused, as the reference refuses it."""
    if not args.arch:
        raise SystemExit("--arch is required for LLM serving")
    args.gen = args.gen or 32
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    return cfg


def _serve_llm(args, device, mesh=None):
    cfg = _llm_config(args)
    max_len = args.max_len or (args.prompt_len + args.gen + 4)
    kw = {}
    if args.workload == "llm_decode_paged":
        bs = args.block_size
        max_len = -(-max_len // bs) * bs  # whole blocks
        kw = {"block_size": bs, "attn": args.attn}
        if args.num_blocks:
            kw["num_blocks"] = args.num_blocks
    if mesh is not None:
        kw["mesh"] = mesh
    wl = make_workload(
        args.workload, cfg=cfg, slots=args.slots, max_len=max_len,
        max_prompt_len=args.prompt_len, seed=args.seed, device=device, **kw,
    )
    reqs = None
    if not args.tenants:
        reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen, args.seed,
                             args.min_prompt_len,
                             arrival_ticks(args.arrival, args.requests, args.seed + 7))
    return wl, reqs


def static_serve(cfg, *, gen: int, batch: int = 0, prompt_len: int = 0, prompt=None,
                 seed: int = 0, device="cuda", params=None, mesh=None) -> dict:
    """The static batch path: ``prompt`` [batch, prompt_len] (by default
    ``batch`` random prompts of ``prompt_len`` tokens, drawn on the device
    from ``seed + 1``; weights from ``seed`` unless ``params`` are given)
    prefilled in one timed ``make_cached_prefill_step``, then ``gen`` timed
    greedy ``make_serve_step`` calls; each timed region is fenced by a
    device synchronize.  Returns the prompts (on the device), the greedy
    tokens [batch, gen] (host), the two times in seconds and the cache's
    bytes.  With ``mesh`` (a world of ``(dp, tp)``) each data rank serves
    its shard of the batch on its blocks of the weights (``params``, when
    given, are already the rank's), and the tokens are gathered over
    ``"data"``."""
    device = resolve_device(device)
    if params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device,
            place=dserve.param_placer(cfg, mesh))
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), device=device,
                               generator=torch.Generator(device=device).manual_seed(seed + 1))
    prompt = torch.as_tensor(prompt, device=device)
    whole = prompt
    if mesh is not None:  # this data rank's sequences
        r, dp = mesh.get_local_rank(shd.DATA), mesh.size(0)
        if prompt.shape[0] % dp:
            raise SystemExit(f"--batch {prompt.shape[0]} does not split over dp={dp} ranks")
        per = prompt.shape[0] // dp
        prompt = prompt[r * per:(r + 1) * per]
    batch, prompt_len = prompt.shape
    serve_step = step_lib.make_serve_step(cfg, mesh)
    prefill_step = step_lib.make_cached_prefill_step(cfg, mesh)
    with dserve.serving_ctx(cfg, mesh):
        cache = transformer.init_cache(cfg, batch, prompt_len + gen, device)
    positions = torch.arange(prompt_len, prompt_len + gen, device=device)

    fence(device)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompt, cache)
    fence(device)
    dt_prefill = time.perf_counter() - t0
    toks = torch.argmax(logits, -1)
    out = []
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(toks)
        logits, cache = serve_step(params, toks, cache, positions[i])
        toks = torch.argmax(logits, -1)
    fence(device)
    dt_decode = time.perf_counter() - t0
    tokens = torch.stack(out, 1)
    if mesh is not None:
        tokens = dserve.gather_batch(tokens, mesh)
    return {"prompt": whole, "tokens": tokens.cpu().numpy(),
            "prefill_s": dt_prefill,
            "decode_s": dt_decode,
            "cache_bytes": sum(t.numel() * t.element_size() for t in cache.values())}


def fence(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _static_main(args, mesh=None) -> dict:
    cfg = _llm_config(args)
    r = static_serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                     seed=args.seed, device=args.device, mesh=mesh)
    pre_tok, dec_tok = args.batch * args.prompt_len, args.batch * args.gen
    print(f"prefill: {pre_tok} tokens in {r['prefill_s'] * 1e3:.1f} ms "
          f"({pre_tok / r['prefill_s']:.1f} tok/s)")
    print(f"decode:  {dec_tok} tokens in {r['decode_s'] * 1e3:.1f} ms "
          f"({dec_tok / r['decode_s']:.1f} tok/s, {r['decode_s'] / args.gen * 1e3:.2f} ms/step)")
    print("sample token ids:", r["tokens"][0][:16].tolist())
    return r


def _print_sla(eng, s) -> None:
    """The SLA, per-tenant, resize and capacity-retry lines (the reference CLI's)."""
    if s["sla_total"]:
        print(f"  SLA {s['sla_met']}/{s['sla_total']} met | goodput {s['goodput_ok']} "
              f"({s['goodput_per_ktick']:.1f}/ktick) | replica-ticks {s['replica_ticks']}")
    for name, t in sorted(s["tenants"].items()):
        print(f"  tenant {name}: {t['completed']} done, {t['tokens_out']} tok | sla "
              f"{t['sla_met']}/{t['sla_total']} | ttft p99 {t['ttft_p99_ticks']:.0f} ticks")
    if s["resizes"] or s["retried"]:
        print(f"  resizes {s['resizes']} | capacity retries {s['retried']} | final dp {eng.dp}")


def main(argv=None):
    """Parse ``argv`` and serve.  ``--continuous``: print the summary and
    return the engine (its ``summary()`` and ``results``); else run the
    static path, print its lines and return :func:`static_serve`'s dict.
    Under ``torch.distributed.run`` this process is one rank of the
    world of ``--tp`` (``--dp`` x ``--tp`` static) ranks."""
    args = build_parser().parse_args(argv)
    from repro_torch.launch import train as train_cli

    needs_model = not (args.continuous and args.workload == "fixedpoint_solve")
    env = train_cli.world_env()
    if env is None or not needs_model:
        if args.tp > 1 and needs_model:
            world = args.tp if args.continuous else args.dp * args.tp
            raise SystemExit(f"--tp {args.tp} needs a world of {world} ranks "
                             f"(python -m torch.distributed.run --nproc-per-node {world} ...)")
        return run(args)
    device = train_cli.start_world(env, args.device)
    try:
        mesh = train_cli.build_mesh(1 if args.continuous else args.dp, args.tp, device.type)
        args.device = str(device)
        quiet = contextlib.nullcontext() if dist.get_rank() == 0 else contextlib.redirect_stdout(
            io.StringIO())
        with quiet:
            return run(args, mesh)
    finally:
        train_cli.end_world()


def kernel_launches() -> dict:
    """Every hand-written kernel's launch count so far."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mrd_combine import ops as mc
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.selective_scan import ops as ss

    return {op.__name__: op.launches for op in (pa.paged_attention, mc.mrd_combine,
                                                fa.flash_attention, rn.rmsnorm,
                                                ss.selective_scan)}


def write_summary(args, out, launches0: dict) -> None:
    """``--summary-json``: this rank's record of ``out`` (the engine, or
    the static path's dict)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = resolve_device(args.device)
    rec = {"rank": rank, "world_size": dist.get_world_size() if dist.is_initialized() else 1,
           "tp": args.tp, "launches": {k: v - launches0[k] for k, v in kernel_launches().items()},
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None)}
    if isinstance(out, dict):
        rec.update(tokens=out["tokens"].tolist(), prefill_s=out["prefill_s"],
                   decode_s=out["decode_s"], cache_bytes=out["cache_bytes"])
    else:
        s = out.summary()
        rec["summary"] = {k: v for k, v in s.items() if isinstance(v, (int, float, str))}
        rec["results"] = {str(i): [np.asarray(r.output).tolist(), r.admit_tick, r.retire_tick]
                          for i, r in out.results.items()}
    with open(args.summary_json.format(rank=rank), "w") as f:
        json.dump(rec, f)


def run(args, mesh=None):
    """:func:`main`'s serving, in this process (``mesh``: its TP world)."""
    launches0 = kernel_launches()
    out = _run(args, mesh)
    if args.summary_json:
        write_summary(args, out, launches0)
    return out


def _run(args, mesh=None):
    if not args.continuous:
        return _static_main(args, mesh)
    eng, wl, res = serve(args, mesh)
    s = eng.summary()
    term = eng.cfg.termination
    first = res[min(res)]
    if args.workload == "fixedpoint_solve":
        print(f"fixedpoint_solve[{args.solver}] x {args.scheduler} x {term} (dp={args.dp}, "
              f"n={args.n}, {wl.device}): {s['completed']} requests in {s['ticks']} ticks / "
              f"{s['wall_s']:.2f} s")
        print(f"  {s['tokens_out'] / s['wall_s']:.1f} slot-iterations/s | "
              f"{s['completed'] / s['wall_s']:.2f} solves/s | occupancy {s['occupancy']:.2f} | "
              f"converged {s['converged']}/{s['completed']}")
        print(f"  TTFT p50/p95 {s['ttft_p50_ms']:.1f}/{s['ttft_p95_ms']:.1f} ms | "
              f"ms a tick {s['wall_s'] / max(s['decode_ticks'], 1) * 1e3:.3f}")
        _print_sla(eng, s)
        print(f"  request {first.id}: {first.n_tokens} iterations, admit@{first.admit_tick} "
              f"retire@{first.retire_tick}, certified {first.certified:.3e}, head "
              f"{np.round(first.output[:4], 6).tolist()}")
        return eng
    paged = args.workload == "llm_decode_paged"
    print(f"{args.workload}{f'[{args.attn}]' if paged else ''} x {args.scheduler} x {term} "
          f"(dp={args.dp}, {wl.cfg.name}{' smoke' if args.smoke else ''}, "
          f"{wl.device}): {s['completed']} requests in {s['ticks']} ticks "
          f"({s['decode_ticks']} decode) / {s['wall_s']:.2f} s")
    print(f"  throughput {s['throughput_tok_s']:.1f} tok/s | occupancy "
          f"{s['occupancy']:.2f} | converged {s['converged']}/{s['completed']} | "
          f"forced-at-capacity {s['forced_at_capacity']}")
    print(f"  TTFT p50/p95 {s['ttft_p50_ms']:.1f}/{s['ttft_p95_ms']:.1f} ms | "
          f"TPOT p50/p95 {s['tpot_p50_ms']:.2f}/{s['tpot_p95_ms']:.2f} ms")
    _print_sla(eng, s)
    print(f"  cache {wl.cache_bytes / 2**20:.2f} MiB"
          + (f" | prefix blocks saved {wl.prefix_saved_blocks}" if paged else ""))
    print(f"  request {first.id}: {first.n_tokens} tokens, admit@{first.admit_tick} "
          f"retire@{first.retire_tick}, head {first.output[:8].tolist()}")
    return eng


if __name__ == "__main__":
    main()
