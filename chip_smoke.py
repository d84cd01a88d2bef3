#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

The run uses one card: it makes only the first visible card visible to
itself, so the device line's ``count`` is the one card that did the work.

Phases, in order (any failure ends the run with a non-zero exit):

1. the card's name and power limit (``nvidia-smi``); TF32 off;
2. build every CUDA kernel of the serving and training paths from
   ``src/`` (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card:
   ``paged_attention`` at the served shapes and the smoke shapes, fp32
   (atol 1e-4) and bf16 (atol 2e-2 against the plain version in fp32);
   ``mrd_combine`` at n = 256, at a [3, 512 k] stacked shape and at the
   largest full-width gradient bucket's [3, len] rows, fp32 and bf16,
   equal bit for bit;
4. the serving path at full width: ``repro_torch.launch.serve`` serves 16
   requests of llama3.2-1b (bf16, random weights from the seed) with
   block-paged decode through the kernel and MRD-agreed retirement across
   3 simulated replicas; every request must retire and the kernel must
   have launched once per layer per decode tick; then a profile of steady
   decode ticks with every slot busy (wall and device-busy time per tick,
   the costliest kernels);
4c. the training path at full width: ``repro_torch.launch.train`` trains
   llama3.2-1b (bf16, random weights from the seed) for 4 steps of 6 x
   1024 tokens at dp 3 with the ``compressed`` gradient sync, after a
   1-step warm-up; every loss must be finite and ``mrd_combine`` must have
   launched once per reducing stage per bucket per step; then a profile
   of one step (device busy time, idle share, the costliest kernels);
5. correctness: one fp32 full-width paged decode step through the kernel
   against the gather path (logits atol 1e-3), and the smoke config served
   on the card and on the CPU, from the same weights, with identical
   tokens and ticks; the smoke config trained with ``compressed`` at dp 3
   for 3 steps on the card and on the CPU, from the same weights and
   batches (losses atol 1e-4, grad norms rtol 5e-4); the full-width
   reduce-scatter plan on fixed fp32 buckets through the kernel on the
   card and through the plain version on the CPU, equal bit for bit;
6. timings with CUDA events after warm-up, L2 flushed before each launch:
   each kernel and its plain version, with ``scaled_dot_product_attention``
   on gathered views beside ``paged_attention`` (a yardstick only; the
   port never calls it; no single PyTorch call computes ``mrd_combine``),
   beside the least time the card could take (bytes at 3.35 TB/s);
7. the kernels line, then the device line as the last line of stdout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# one card: the first of those visible (set before torch initializes CUDA)
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
# the full-width train step frees and allocates multi-GB buffers of many
# sizes; growable segments keep the caching allocator from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers a call's host launch time
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SERVE_ARGV = [
    "--arch", "llama3.2-1b", "--continuous", "--workload", "llm_decode_paged",
    "--attn", "kernel", "--dp", "3", "--slots", "8", "--requests", "16",
    "--prompt-len", "64", "--gen", "32", "--block-size", "16",
]
TRAIN_ARGV = [
    "--arch", "llama3.2-1b", "--steps", "4", "--batch", "6", "--seq", "1024", "--dp", "3",
    "--grad-sync", "compressed", "--device", "cuda",
]
# rows of the largest full-width gradient bucket (w1, w2, w3: 16 x 2048 x 8192)
BIG_BUCKET = 16 * 2048 * 8192
# mrd_combine element counts: one block, a [3, 512 k] stacked shape, the
# largest bucket's [3, len] rows flattened
COMBINE_CASES = [256, 3 * 512 * 7, 3 * BIG_BUCKET]
# (S, H, KV, hd, nb, bs): the served full-width shape first, then the smoke
# shape, then rep 1 with 16-token blocks (every template family once)
KERNEL_CASES = [(8, 32, 8, 64, 7, 16), (8, 4, 2, 16, 3, 8), (4, 4, 4, 16, 3, 16)]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> float:
    t = time.perf_counter()
    log(f"# phase {name}: {t - t0:.1f} s")
    return t


def paged_inputs(seed, S, H, KV, hd, nb, bs, dtype, device="cuda"):
    """Random q + pools, a disjoint table over permuted physical blocks, and
    ragged lengths including a full row and a length-1 row."""
    rng = np.random.default_rng(seed)
    N = S * nb + 1
    q = torch.from_numpy(rng.standard_normal((S, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((N, bs, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((N, bs, KV, hd)).astype(np.float32))
    tables = rng.permutation(np.arange(1, N))[: S * nb].reshape(S, nb).astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, size=S).astype(np.int32)
    lengths[0], lengths[-1] = nb * bs, 1
    return ([t.to(device=device, dtype=dtype) for t in (q, k, v)]
            + [torch.from_numpy(a).to(device) for a in (tables, lengths)])


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each call
    (the decode path finds its K/V cold: a tick streams all the weights).
    The flush reads a 64 MB buffer: a write would leave dirty lines whose
    write-back the timed call would pay for.

    A spin on the stream (~1 ms) precedes each call, so the host has queued
    the flush and the whole call before the device reaches them: the events
    time the device's work, not the host's launch latency."""
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):  # also writes back the lines zeros() left dirty
        flush.max()
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.max()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def device_profile(fn, reps: int):
    """Run ``fn`` ``reps`` times under ``torch.profiler`` (CUPTI kernel
    records): (device-busy ms per rep, {kernel name: (ms per rep,
    launches per rep)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    if not by_name:
        raise SystemExit("the profiler recorded no device time")
    busy_ms = sum(ms for ms, _ in by_name.values()) / reps
    return busy_ms, {k: (ms / reps, n / reps) for k, (ms, n) in by_name.items()}


def top_kernels(per_rep: dict, top: int = 8):
    return sorted(per_rep.items(), key=lambda kv: -kv[1][0])[:top]


def profile_decode(wl, reqs, ticks: int = 8):
    """Admit ``reqs`` into every slot of ``wl`` and run steady decode ticks:
    (host wall ms per tick, device-busy ms per tick, every kernel's entry
    by name).  The wall time is taken without the profiler; the device
    time with it."""
    wl.reset()
    for slot, req in enumerate(reqs[: wl.slots]):
        wl.admit(req, slot, 0)
    active = np.ones(wl.slots, bool)
    for _ in range(2):
        wl.step(active)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ticks):
        wl.step(active)  # ends in a device-to-host copy of the tokens
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / ticks
    busy_ms, per_tick = device_profile(lambda: wl.step(active), ticks)
    return wall_ms, busy_ms, per_tick


def to_device(tree, device):
    """A deep copy of a state tree (dicts of tensors and host scalars) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True) if isinstance(tree, torch.Tensor) else tree


def combine_inputs(n: int, dtype, seed: int):
    """x ~ N(0, 1), q uniform in [-127, 127], positive scales: drawn on the
    card (the largest case is 805 M elements)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    q = torch.randint(-127, 128, (n,), generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand(n // 256, generator=gen, device="cuda") * 0.1 + 1e-4
    return x, q, s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible, needs one", file=sys.stderr)
        return 2
    from repro_torch.collectives import plans
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import serve as dserve
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels import build
    from repro_torch.kernels.mrd_combine import ops as mc_ops
    from repro_torch.kernels.mrd_combine.ref import mrd_combine_ref
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.serving import PagedDecodePool, ServeConfig, ServeEngine, make_workload

    t0 = time.perf_counter()
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = phase("device", t0)

    # 2. build: one nvcc per source, all started together
    sources = {"paged_attention": ops.SOURCE, "mrd_combine": mc_ops.SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {name: pool.submit(build.build_shared_library, src, name)
                for name, src in sources.items()}
        built = {name: f.result() for name, f in futs.items()}
    ops.library()
    mc_ops.library()
    for name, so in built.items():
        log(f"built {so.relative_to(ROOT)}")
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({name}): {line.strip()}")
    log(f"build of {len(built)} kernels: {time.perf_counter() - t:.1f} s")
    t = phase("build", t)

    # 3. kernel vs plain on the card
    errs = {}
    for case in KERNEL_CASES:
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = paged_inputs(0, *case, dtype)
            out = ops.paged_attention(*args)
            ref = paged_attention_ref(*[a.float() if a.is_floating_point() else a for a in args])
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != ref.shape:
                raise SystemExit(f"kernel output {out.dtype} {tuple(out.shape)} is wrong")
            err = (out.float() - ref).abs().max().item()
            errs[(case, dtype)] = err
            log(f"  kernel vs plain S,H,KV,hd,nb,bs={case} {str(dtype)[6:]}: "
                f"max abs err {err:.3e} (atol {atol:g})")
            if not err <= atol:
                raise SystemExit(f"paged_attention kernel disagrees with its plain version: {err}")
    for n in COMBINE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, q, sc = combine_inputs(n, dtype, seed=n % 1000)
            out = mc_ops.mrd_combine(x, q, sc)
            ref = mrd_combine_ref(x, q, sc)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != ref.shape:
                raise SystemExit(f"mrd_combine output {out.dtype} {tuple(out.shape)} is wrong")
            err = (out.float() - ref.float()).abs().max().item()
            errs[(n, dtype)] = err
            log(f"  mrd_combine vs plain n={n} {str(dtype)[6:]}: max abs err {err:.3e}, "
                f"bit for bit {torch.equal(out, ref)}")
            if not torch.equal(out, ref):
                raise SystemExit(f"mrd_combine kernel differs from its plain version: {err}")
            del x, q, sc, out, ref
    torch.cuda.empty_cache()
    t = phase("kernel-vs-plain", t)

    # 4. the serving path at full width, counted (after a short warm-up run
    # that initializes the GEMM libraries, so the figures are steady state)
    serve.main(SERVE_ARGV + ["--requests", "2", "--gen", "4", "--device", "cuda"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.paged_attention.launches = mc_ops.mrd_combine.launches = 0
    eng = serve.main(SERVE_ARGV + ["--device", "cuda"])
    launches = ops.paged_attention.launches
    if mc_ops.mrd_combine.launches:
        raise SystemExit("the serving path launched mrd_combine")
    s = eng.summary()
    n_layers = registry.get_config("llama3.2-1b").n_layers
    log(f"served {s['completed']}/16 requests, {s['decode_ticks']} decode ticks, "
        f"kernel launches {launches} (= {s['decode_ticks']} x {n_layers} layers expected)")
    log(f"  tok/s {s['throughput_tok_s']:.1f} | TTFT p50 {s['ttft_p50_ms']:.2f} ms | "
        f"TPOT p50 {s['tpot_p50_ms']:.3f} ms | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if s["completed"] != 16 or s["forced_at_capacity"]:
        raise SystemExit(f"not every request retired naturally: {s}")
    if launches != s["decode_ticks"] * n_layers or launches == 0:
        raise SystemExit(f"kernel launches {launches} != decode ticks x layers")
    vocab = registry.get_config("llama3.2-1b").vocab
    for r in eng.results.values():
        if not (1 <= r.n_tokens and ((r.output >= 0) & (r.output < vocab)).all()):
            raise SystemExit(f"request {r.id}: bad output {r.output}")
    serve_stats = dict(s)
    t = phase("serve-full-width", t)

    # 4b. where a steady decode tick's time goes (8 busy slots, bf16)
    wall_ms, busy_ms, per_tick = profile_decode(
        eng.workload, serve.make_requests(eng.workload.cfg, 8, 64, 32, seed=1))
    log(f"steady decode tick, 8 slots: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms_tick, n_tick) in top_kernels(per_tick):
        log(f"  {ms_tick * 1e3:9.2f} us/tick {n_tick:6.1f} launches/tick  {name[:110]}")
    pa = [v for k, v in per_tick.items() if "paged_attention_kernel" in k]
    if not pa:
        raise SystemExit("the profiled decode ticks launched no paged_attention kernel")
    log(f"  paged_attention in steady decode: {pa[0][0] / pa[0][1] * 1e3:.2f} us a launch, "
        f"{pa[0][1]:.0f} launches/tick, {pa[0][0] / busy_ms:.3f} of device busy time")
    del eng
    torch.cuda.empty_cache()
    t = phase("profile-decode", t)

    # 4c. the training path at full width, counted (after a 1-step warm-up
    # run that initializes the GEMM libraries)
    train.main(TRAIN_ARGV + ["--steps", "1"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.paged_attention.launches = mc_ops.mrd_combine.launches = 0
    rec = train.main(TRAIN_ARGV)
    train_launches = mc_ops.mrd_combine.launches
    if ops.paged_attention.launches:
        raise SystemExit("the training path launched paged_attention")
    targs = train.build_parser().parse_args(TRAIN_ARGV)
    layout, _ = step_lib.zero1_layout(rec["state"]["params"], targs.dp)
    stages = [st for st, _ in plans.reduce_scatter_plan(p=targs.dp).stage_table
              if st.kind in ("bshift", "rs")]
    expect = len(rec["losses"]) * len(stages) * len(layout.buckets)
    log(f"trained {len(rec['losses'])} steps, losses {rec['losses']}, grad norms "
        f"{rec['grad_norms']}")
    log(f"  mrd_combine launches {train_launches} (= {len(rec['losses'])} steps x "
        f"{len(stages)} reducing stages x {len(layout.buckets)} buckets = {expect} expected)")
    log(f"  ms/step {[round(m, 3) for m in rec['ms_per_step']]} | tokens/s (steps 2-4) "
        f"{rec['tokens_per_s']:.1f} | peak device memory {rec['peak_bytes'] / 2**30:.3f} GiB")
    if len(rec["losses"]) != targs.steps or not all(np.isfinite(rec["losses"] + rec["grad_norms"])):
        raise SystemExit(f"training did not finish every step with finite values: {rec}")
    if train_launches != expect or train_launches == 0:
        raise SystemExit(f"mrd_combine launches {train_launches} != {expect}")
    train_stats = {k: rec[k] for k in ("losses", "grad_norms", "ms_per_step", "tokens_per_s")}
    train_stats["peak_gib"] = rec["peak_bytes"] / 2**30
    t = phase("train-full-width", t)

    # 4d. where a train step's time goes (one step after the counted run)
    _, _, train_step, pipe = train.make(targs)
    state = {"s": rec.pop("state")}
    batch = pipe.next_batch()

    def one_step():
        state["s"], m = train_step(state["s"], batch)
        return m

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    float(one_step()["loss"])
    step_wall_ms = (time.perf_counter() - t1) * 1e3
    step_busy_ms, per_step = device_profile(one_step, 1)
    log(f"train step (6 x 1024 tokens, dp 3, compressed): wall {step_wall_ms:.1f} ms, device "
        f"busy {step_busy_ms:.1f} ms, device idle share {1 - step_busy_ms / step_wall_ms:.3f}")
    for name, (ms_s, n_s) in top_kernels(per_step, 12):
        log(f"  {ms_s:10.3f} ms/step {n_s:6.0f} launches/step  {name[:110]}")
    classes = {"GEMM": 0.0, "mrd_combine": 0.0, "other": 0.0}
    for name, (ms_s, _) in per_step.items():
        key = ("mrd_combine" if "mrd_combine_kernel" in name else
               "GEMM" if any(w in name.lower() for w in ("nvjet", "gemm", "cutlass", "sm90_"))
               else "other")
        classes[key] += ms_s
    log("  device time by class: " + ", ".join(
        f"{k} {v:.3f} ms ({v / step_busy_ms:.3f})" for k, v in classes.items()))
    mc = [v for k, v in per_step.items() if "mrd_combine_kernel" in k]
    if not mc:
        raise SystemExit("the profiled train step launched no mrd_combine kernel")
    log(f"  mrd_combine in a train step: {mc[0][0]:.3f} ms over {mc[0][1]:.0f} launches, "
        f"{mc[0][0] / step_busy_ms:.4f} of device busy time")
    train_stats.update(step_wall_ms=step_wall_ms, step_busy_ms=step_busy_ms,
                       idle_share=1 - step_busy_ms / step_wall_ms, busy_ms_by_class=classes)
    del state, train_step, pipe, batch, rec, layout
    torch.cuda.empty_cache()
    t = phase("profile-train", t)

    # 5a. fp32 full width: kernel path vs gather path on the same state
    cfg32 = registry.override(registry.get_config("llama3.2-1b"),
                              param_dtype="float32", compute_dtype="float32")
    params = transformer.init_params(cfg32, torch.Generator(device="cuda").manual_seed(1), "cuda")
    pool = PagedDecodePool(cfg32, slots=8, max_len=112, max_prompt_len=64, block_size=16,
                           attn="kernel", device="cuda")
    rng = np.random.default_rng(2)
    for slot in range(8):
        plen = int(rng.integers(1, 65))
        pool.admit(params, rng.integers(0, cfg32.vocab, size=plen), slot, max_new=32)
    lengths = torch.from_numpy(pool.lengths).cuda()
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    logits = {}
    for attn in ("kernel", "gather"):
        pages = {n: p.clone() for n, p in pool.pages.items()}
        step = dserve.make_paged_pool_decode_step(cfg32, 16, attn=attn)
        logits[attn] = step(params, pool.tokens, pages, pool.tables, lengths, active)
    diff = (logits["kernel"] - logits["gather"]).abs().max().item()
    same = int((logits["kernel"].argmax(-1) == logits["gather"].argmax(-1)).sum())
    log(f"fp32 full width, one paged decode step: kernel vs gather logits max abs diff "
        f"{diff:.3e} (atol 1e-3), argmax equal {same}/8, finite "
        f"{bool(torch.isfinite(logits['kernel']).all())}")
    if not (diff <= 1e-3 and torch.isfinite(logits["kernel"]).all()):
        raise SystemExit("full-width kernel path disagrees with the gather path")
    del params, pool, logits
    torch.cuda.empty_cache()

    # 5b. smoke config served on the card (kernel) and on the CPU (plain
    # version) with the same weights: a torch.Generator draws other numbers
    # on each device, so the weights are drawn once on the CPU and copied
    smoke = registry.get_smoke_config("llama3.2-1b")
    cpu_params = transformer.init_params(smoke, torch.Generator().manual_seed(0), "cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        params = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
                  for k, v in cpu_params.items()}
        wl = make_workload("llm_decode_paged", cfg=smoke, slots=3, max_len=24,
                           max_prompt_len=12, params=params, device=dev, block_size=8,
                           attn="kernel")
        reqs = serve.make_requests(smoke, 6, 12, 9, seed=0)
        res[dev] = ServeEngine(wl, ServeConfig(dp=3)).run(reqs)
    for i, r in res["cpu"].items():
        g = res["cuda"][i]
        if not (np.array_equal(g.output, r.output)
                and (g.admit_tick, g.retire_tick) == (r.admit_tick, r.retire_tick)):
            raise SystemExit(f"smoke request {i}: card {g} != cpu {r}")
    log(f"smoke serve at dp 3: {len(res['cpu'])} requests, card (kernel) == cpu (plain) "
        f"token for token and tick for tick")

    # 5c. smoke config trained with the compressed sync on the card (kernel)
    # and on the CPU (plain version): same weights (drawn once on the CPU)
    # and batches.  Tolerances: fp32 GEMMs sum in another order on the card
    # (TF32 off), and a gradient on an int8 rounding tie may round the other
    # way (one quantization step in one coordinate).
    tcfg = step_lib.TrainConfig(
        remat="none", grad_sync="compressed", monitor=True, monitor_threshold=100.0,
        bucket_bytes=1 << 15,
        optimizer=OptimizerConfig(lr=1e-2, schedule="const", warmup_steps=0))
    steps = {dev: step_lib.make_train_step(smoke, tcfg, dp=3, device=dev) for dev in ("cpu", "cuda")}
    st_cpu = steps["cpu"].init_state(torch.Generator().manual_seed(0))
    sts = {"cuda": to_device(st_cpu, "cuda"), "cpu": st_cpu}
    pipe = SyntheticPipeline(smoke, DataConfig(batch=6, seq_len=16, seed=0), "cpu")
    batches = [pipe.next_batch() for _ in range(3)]
    hist = {dev: [] for dev in sts}
    n0 = mc_ops.mrd_combine.launches
    for dev in sts:
        for b in batches:
            sts[dev], m = steps[dev](sts[dev], to_device(b, dev))
            hist[dev].append((float(m["loss"]), float(m["grad_norm"]), bool(m["converged"])))
    for (lg, gg, cg), (lc, gc, cc) in zip(hist["cuda"], hist["cpu"]):
        if not (abs(lg - lc) <= 1e-4 and abs(gg - gc) <= 5e-4 * abs(gc) and cg == cc):
            raise SystemExit(f"smoke training: card {hist['cuda']} != cpu {hist['cpu']}")
    log(f"smoke train compressed dp 3, 3 steps: card (kernel, {mc_ops.mrd_combine.launches - n0} "
        f"launches) {hist['cuda']} vs cpu (plain) {hist['cpu']}: losses atol 1e-4, grad norms "
        f"rtol 5e-4, monitor flags equal")
    if mc_ops.mrd_combine.launches == n0:
        raise SystemExit("the smoke training on the card launched no mrd_combine kernel")

    # 5d. the full-width reduce-scatter plan (dp 3, int8) on fixed fp32
    # buckets of the full-width layout's lengths: final_norm, the two norm
    # stacks, wk and w1.  Card through the kernel == CPU through the plain
    # version, bit for bit.
    rs_lens = [2048, 2 * 16 * 2048, 16 * 2048 * 512, BIG_BUCKET]
    gen = torch.Generator().manual_seed(5)
    fixed = [torch.randn((3, n), generator=gen) for n in rs_lens]
    rs = plans.reduce_scatter_plan(p=3, transform="int8")
    n0 = mc_ops.mrd_combine.launches
    red_gpu = rs.run_buffers([b.cuda() for b in fixed])
    torch.cuda.synchronize()
    rs_launches = mc_ops.mrd_combine.launches - n0
    red_cpu = rs.run_buffers(fixed)
    for g, c in zip(red_gpu, red_cpu):
        if not torch.equal(g.cpu(), c):
            raise SystemExit(f"full-width reduce-scatter: card != cpu, max abs diff "
                             f"{(g.cpu() - c).abs().max().item()}")
    log(f"full-width reduce-scatter (int8, dp 3) on buckets of {rs_lens} elements: card "
        f"({rs_launches} kernel launches) == cpu (plain version) bit for bit")
    del red_gpu, red_cpu, fixed
    torch.cuda.empty_cache()
    t = phase("correctness", t)

    # 6. timings at the served decode shape (bf16)
    S, H, KV, hd, nb, bs = KERNEL_CASES[0]
    q, k, v, tables, lens = paged_inputs(3, *KERNEL_CASES[0], torch.bfloat16)
    ms = time_ms(lambda: ops.paged_attention(q, k, v, tables, lens))
    plain_ms = time_ms(lambda: paged_attention_ref(q, k, v, tables, lens))
    W = nb * bs
    kg = k[tables.long()].reshape(S, W, KV, hd).transpose(1, 2).repeat_interleave(H // KV, 1)
    vg = v[tables.long()].reshape(S, W, KV, hd).transpose(1, 2).repeat_interleave(H // KV, 1)
    mask = (torch.arange(W, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qg = q[:, :, None, :]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask))
    tot = int(lens.sum())
    n_bytes = (2 * q.numel() * q.element_size()  # q in, out written
               + 2 * tot * KV * hd * k.element_size()  # K and V of live positions
               + tables.numel() * 4 + lens.numel() * 4)
    n_ops = 4 * tot * H * hd  # q.k and p.v, a multiply-add each
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"timings at S,H,KV,hd,nb,bs={KERNEL_CASES[0]} bf16, sum(lengths)={tot}: "
        f"kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | sdpa on gathered "
        f"views {library_ms * 1e3:.2f} us | bound {bound_ms * 1e3:.3f} us "
        f"({n_bytes} bytes at 3.35 TB/s; ops bound {ops_ms * 1e3:.4f} us)")

    # mrd_combine at the largest bucket's stacked rows, fp32 (as the
    # compressed reduce-scatter calls it)
    x, q, sc = combine_inputs(COMBINE_CASES[-1], torch.float32, seed=3)
    mc_ms = time_ms(lambda: mc_ops.mrd_combine(x, q, sc), iters=20)
    mc_plain_ms = time_ms(lambda: mrd_combine_ref(x, q, sc), iters=10)
    n = x.numel()
    mc_bytes = n * (4 + 1 + 4) + (n // 256) * 4  # x, q in; out; scales
    mc_bytes_ms, mc_ops_ms = mc_bytes / HBM_BYTES_PER_S * 1e3, 2 * n / FP32_FLOPS * 1e3
    mc_bound_ms = max(mc_bytes_ms, mc_ops_ms)
    log(f"timings mrd_combine n={n} fp32 ([3, {n // 3}] rows): kernel {mc_ms:.4f} ms | plain "
        f"{mc_plain_ms:.4f} ms | bound {mc_bound_ms:.4f} ms ({mc_bytes} bytes at 3.35 TB/s; "
        f"ops bound {mc_ops_ms:.4f} ms) | no single PyTorch call computes it")
    del x, q, sc
    t = phase("timings", t)

    # 7. results
    log(json.dumps({"serve": {k: serve_stats[k] for k in (
        "completed", "decode_ticks", "tokens_out", "throughput_tok_s", "ttft_p50_ms",
        "tpot_p50_ms", "wall_s")}}))
    log(json.dumps({"train": train_stats}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/paged_kernel.py:78",
        "launches": launches,
        "max_abs_err": errs[(KERNEL_CASES[0], torch.bfloat16)],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }, {
        "name": "mrd_combine",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mrd_combine/csrc/mrd_combine.cu",
        "replaces": "src/repro/kernels/mrd_combine/kernel.py:31",
        "launches": train_launches,
        "max_abs_err": errs[(COMBINE_CASES[-1], torch.float32)],
        "ms": mc_ms,
        "plain_ms": mc_plain_ms,
        "bound_ms": mc_bound_ms,
        "bound_by": "bytes" if mc_bytes_ms >= mc_ops_ms else "operations",
        "library_ms": None,
    }]}))
    log(f"gpu: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
