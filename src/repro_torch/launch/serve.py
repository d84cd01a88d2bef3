"""Serving command line (port of ``repro.launch.serve``, the continuous
path).

  python -m repro_torch.launch.serve --arch llama3.2-1b --continuous \\
      --workload llm_decode_paged --attn kernel --dp 3 --slots 8 \\
      --requests 16 --prompt-len 64 --gen 32 --block-size 16
  python -m repro_torch.launch.serve --arch gemma3-12b --continuous \\
      --workload llm_decode --dp 3 --slots 4 --requests 8 \\
      --min-prompt-len 1024 --prompt-len 8192 --gen 32
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --continuous \\
      --workload llm_decode --dp 3 --slots 8 --requests 16 \\
      --min-prompt-len 1024 --prompt-len 8192 --gen 64 --max-len 8320

serve the full-width config with random bf16 weights made from ``--seed``
on the card; ``--smoke`` takes the reduced config.  ``llm_decode`` keeps
a contiguous cache per slot (rolling local windows and the mamba1 state
included); ``llm_decode_paged`` a block-paged one (attention caches
without a rolling window).  Every admission prefills its prompt in one
causal forward (on the card: the flash-attention kernel, or one
selective-scan kernel launch a mamba1 layer); a mamba1 decode tick runs
the same kernel one step from the slot's state.  ``--dp`` replicas are
simulated: they agree on every retirement through the MRD plan, as the
reference's continuous path does.  ``--device`` defaults to ``cuda`` and
raises when there is no card; ``--device cpu`` runs on the CPU, where
every kernel is its plain PyTorch version.  The reference's static batch
path, its fixed-point workload, tenants, elastic resize and telemetry are
not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.serving import (
    SCHEDULERS,
    WORKLOADS,
    Request,
    ServeConfig,
    ServeEngine,
    make_workload,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching ServeEngine "
                         "(the only ported path; required)")
    ap.add_argument("--workload", default="llm_decode_paged", choices=sorted(WORKLOADS))
    ap.add_argument("--attn", default="kernel", choices=("kernel", "gather"),
                    help="paged decode attention: the CUDA kernel reading K/V "
                         "through the block table, or gathered contiguous views")
    ap.add_argument("--scheduler", default="fcfs", choices=sorted(SCHEDULERS))
    ap.add_argument("--dp", type=int, default=1,
                    help="termination-agreement replicas (MRD over [dp])")
    ap.add_argument("--slots", type=int, default=4, help="decode pool slots")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16, help="longest prompt")
    ap.add_argument("--min-prompt-len", type=int, default=1, help="shortest prompt")
    ap.add_argument("--gen", type=int, default=32, help="largest generation budget")
    ap.add_argument("--max-len", type=int, default=0,
                    help="pool cache length (0 = prompt+gen+4, rounded up to blocks "
                         "when paged)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="tokens per cache block (llm_decode_paged)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="physical blocks (llm_decode_paged; 0 = contiguous-capacity parity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def make_requests(cfg, n: int, prompt_len: int, gen: int, seed: int,
                  min_prompt_len: int = 1) -> list[Request]:
    """``n`` requests queued at tick 0: prompt lengths uniform in
    [min_prompt_len, prompt_len], budgets uniform in [gen/2, gen].  With
    ``min_prompt_len`` 1 the draws follow the reference CLI's stream at the
    same ``seed`` (it also draws a priority and an SLA per request, which
    fcfs ignores), so both queue the same prompts and budgets."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(min_prompt_len, prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        max_new = int(rng.integers(max(1, gen // 2), gen + 1))
        rng.integers(0, 3), rng.integers(4, 64)  # priority, SLA
        reqs.append(Request(id=i, arrival=0, prompt=prompt, max_new=max_new))
    return reqs


def serve(args: argparse.Namespace):
    """Build the workload and engine from parsed ``args`` and serve
    ``--requests`` requests -> (engine, workload, results)."""
    if not args.continuous:
        raise SystemExit("only the --continuous serving path is ported")
    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    max_len = args.max_len or (args.prompt_len + args.gen + 4)
    kw = {}
    if args.workload == "llm_decode_paged":
        bs = args.block_size
        max_len = -(-max_len // bs) * bs  # whole blocks
        kw = {"block_size": bs, "attn": args.attn}
        if args.num_blocks:
            kw["num_blocks"] = args.num_blocks
    wl = make_workload(
        args.workload, cfg=cfg, slots=args.slots, max_len=max_len,
        max_prompt_len=args.prompt_len, seed=args.seed, device=device, **kw,
    )
    eng = ServeEngine(wl, ServeConfig(
        scheduler=args.scheduler, termination=wl.default_termination, dp=args.dp,
    ))
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen, args.seed,
                         args.min_prompt_len)
    return eng, wl, eng.run(reqs)


def main(argv=None) -> ServeEngine:
    """Parse ``argv``, serve, print the summary; returns the engine (its
    ``summary()`` and ``results``)."""
    args = build_parser().parse_args(argv)
    eng, wl, res = serve(args)
    s = eng.summary()
    paged = args.workload == "llm_decode_paged"
    print(f"{args.workload}{f'[{args.attn}]' if paged else ''} x {args.scheduler} x eos_maxlen "
          f"(dp={args.dp}, {wl.cfg.name}{' smoke' if args.smoke else ''}, "
          f"{wl.device}): {s['completed']} requests in {s['ticks']} ticks "
          f"({s['decode_ticks']} decode) / {s['wall_s']:.2f} s")
    print(f"  throughput {s['throughput_tok_s']:.1f} tok/s | occupancy "
          f"{s['occupancy']:.2f} | forced-at-capacity {s['forced_at_capacity']}")
    print(f"  TTFT p50/p95 {s['ttft_p50_ms']:.1f}/{s['ttft_p95_ms']:.1f} ms | "
          f"TPOT p50/p95 {s['tpot_p50_ms']:.2f}/{s['tpot_p95_ms']:.2f} ms")
    print(f"  cache {wl.cache_bytes / 2**20:.2f} MiB"
          + (f" | prefix blocks saved {wl.prefix_saved_blocks}" if paged else ""))
    first = res[min(res)]
    print(f"  request {first.id}: {first.n_tokens} tokens, admit@{first.admit_tick} "
          f"retire@{first.retire_tick}, head {first.output[:8].tolist()}")
    return eng


if __name__ == "__main__":
    main()
