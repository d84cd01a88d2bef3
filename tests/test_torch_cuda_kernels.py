"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card (the kernels have no CPU mode) and skip without
one.  On the card, from the repository root:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

This file imports neither JAX nor the reference package, so it runs on a
machine that has only the port's dependencies.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

pytestmark = pytest.mark.cuda

# (S, H, KV, hd, nb, bs): served full width, smoke, rep 1, rep 4 with hd 16
CASES = [(8, 32, 8, 64, 7, 16), (8, 4, 2, 16, 3, 8), (4, 4, 4, 16, 3, 16), (3, 8, 2, 16, 5, 8),
         # qwen2.5-32b's and llama4-scout's heads (rep 5, hd 128) over 66 pages
         # (5 splits), internvl2-1b's (rep 7, hd 64), minicpm-2b's (rep 1, hd 64)
         (8, 40, 8, 128, 66, 16), (8, 14, 2, 64, 5, 16), (4, 36, 36, 64, 3, 16),
         # zamba2-2.7b's shared block (32/32 heads at hd 80) over 260 pages (17
         # splits); the smoke configs' heads: internvl2-1b's (rep 7, hd 8),
         # minicpm-2b's (rep 1, hd 12)
         (8, 32, 32, 80, 260, 16), (4, 7, 1, 8, 3, 8), (4, 6, 6, 12, 3, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, S, H, KV, hd, nb, bs, dtype, device):
    rng = np.random.default_rng(seed)
    N = S * nb + 1
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
               for sh in ((S, H, hd), (N, bs, KV, hd), (N, bs, KV, hd)))
    tables = rng.permutation(np.arange(1, N))[: S * nb].reshape(S, nb).astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, size=S).astype(np.int32)
    lengths[0], lengths[-1] = nb * bs, 1
    return [q, k, v, torch.from_numpy(tables).to(device), torch.from_numpy(lengths).to(device)]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case, dtype, atol):
    """fp32 within 1e-4 (summation order only); bf16 within 2e-2 of the
    plain version computed in fp32 on the same bf16 inputs (output
    rounding to bf16)."""
    args = _inputs(0, *case, getattr(torch, dtype), cuda)
    n0 = ops.paged_attention.launches
    out = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == n0 + 1
    assert out.dtype == args[0].dtype and out.device.type == "cuda"
    ref = paged_attention_ref(*[a.float() if a.is_floating_point() else a for a in args])
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


def test_unsupported_shape_raises_on_the_card(cuda):
    """No fallback to the plain version for a CUDA tensor."""
    args = _inputs(1, 2, 4, 2, 32, 2, 8, torch.float32, cuda)  # head dim 32
    n0 = ops.paged_attention.launches
    with pytest.raises(ValueError):
        ops.paged_attention(*args)
    assert ops.paged_attention.launches == n0


# every hd x rep x bs instance, at lengths that probe the v2 kernel's edges:
# 1, page multiples, the 256-position split's boundaries +-1, a full table
EDGE_LENGTHS = [1, 8, 16, 32, 255, 256, 257, 511, 512, 513, 1024]
EDGE_INSTANCES = [(hd, rep, bs) for hd in (8, 12, 16, 64, 80, 128) for rep in (1, 2, 4, 5, 7)
                  for bs in (8, 16)]


def _edge_inputs(seed, lengths, H, KV, hd, bs, dtype, device):
    """A table of max(lengths) positions for each sequence, over permuted
    physical blocks, with the given lengths."""
    rng = np.random.default_rng(seed)
    S, nb = len(lengths), -(-max(lengths) // bs)
    N = S * nb + 1
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
               for sh in ((S, H, hd), (N, bs, KV, hd), (N, bs, KV, hd)))
    tables = rng.permutation(np.arange(1, N))[: S * nb].reshape(S, nb).astype(np.int32)
    return [q, k, v, torch.from_numpy(tables).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device)]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("hd,rep,bs", EDGE_INSTANCES)
def test_kernel_at_split_and_page_edges(cuda, hd, rep, bs, dtype, atol):
    """Lengths 1, page multiples and the split boundaries +-1 in one table
    of 1,024 positions (4 splits, merged by the combine kernel): one call."""
    args = _edge_inputs(hd + rep + bs, EDGE_LENGTHS, 2 * rep, 2, hd, bs,
                        getattr(torch, dtype), cuda)
    assert ops.split_plan(args[3].shape[1], bs)[1] == 4
    n0 = ops.paged_attention.launches
    out = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == n0 + 1  # one call, two kernels
    ref = paged_attention_ref(*[a.float() if a.is_floating_point() else a for a in args])
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_kernel_at_long_context(cuda, dtype, atol):
    """8 sequences x 4,096 positions at llama3.2-1b's heads (16 splits)."""
    args = _inputs(5, 8, 32, 8, 64, 256, 16, getattr(torch, dtype), cuda)
    out = ops.paged_attention(*args)
    ref = paged_attention_ref(*[a.float() if a.is_floating_point() else a for a in args])
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_kernel_takes_unaligned_inputs(cuda, dtype, atol):
    """q and the pools 4 (fp32) or 2 (bf16) bytes past a 16-byte boundary:
    the wrapper hands the kernel aligned copies, and the result holds."""
    args = _inputs(6, 8, 32, 8, 64, 7, 16, getattr(torch, dtype), cuda)
    for i in range(3):
        flat = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device=cuda)
        args[i] = flat[1:].view(args[i].shape).copy_(args[i])
        assert args[i].data_ptr() % ops.ALIGN
    out = ops.paged_attention(*args)
    ref = paged_attention_ref(*[a.float() if a.is_floating_point() else a for a in args])
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


# --- mrd_combine ------------------------------------------------------------

from repro_torch.kernels.mrd_combine import ops as mc_ops  # noqa: E402
from repro_torch.kernels.mrd_combine.ref import mrd_combine_ref  # noqa: E402


def _combine_inputs(seed, n, dtype, device):
    """x ~ N(0, 1), q uniform in [-127, 127], scales amax/127-sized with an
    all-ones (amax 0) block, as the int8 transform makes them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device, dtype)
    q = torch.from_numpy(rng.integers(-127, 128, size=n).astype(np.int8)).to(device)
    s = rng.uniform(1e-4, 1e-1, size=n // 256).astype(np.float32)
    s[0] = 1.0
    return x, q, torch.from_numpy(s).to(device)


# one and three 256-blocks; the kernel's CUDA block (8 warps, a 256-block
# each: 2,048 elements) +- 256 and a last block with one live warp; the smoke
# config's [3, len] reduce-scatter rows (compressed, dp 3); stacked shapes
COMBINE_LENGTHS = [256, 768, 1792, 2048, 2304, 5 * 2048 + 256, 6912, 12288, 13824, 24576, 49152,
                   3 * 512 * 7, 3 * 512 * 4099]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", COMBINE_LENGTHS)
def test_mrd_combine_matches_plain_bit_for_bit(cuda, n, dtype):
    """Exact in both types: the kernel rounds the product and the sum
    separately (no FMA), as the plain version does, and casts the fp32
    sum to bf16 round-to-nearest-even."""
    x, q, s = _combine_inputs(n, n, getattr(torch, dtype), cuda)
    n0 = mc_ops.mrd_combine.launches
    out = mc_ops.mrd_combine(x, q, s)
    torch.cuda.synchronize()
    assert mc_ops.mrd_combine.launches == n0 + 1
    assert out.dtype == x.dtype and out.device.type == "cuda"
    assert torch.equal(out, mrd_combine_ref(x, q, s))


def test_mrd_combine_refuses_what_it_does_not_take_on_the_card(cuda):
    """No fallback to the plain version for a CUDA tensor."""
    x, q, s = _combine_inputs(0, 512, torch.float32, cuda)
    n0 = mc_ops.mrd_combine.launches
    with pytest.raises(ValueError):
        mc_ops.mrd_combine(x[:300], q[:300], s[:1])
    with pytest.raises(TypeError):
        mc_ops.mrd_combine(x.half(), q, s)
    with pytest.raises(ValueError):
        mc_ops.mrd_combine(x, q.cpu(), s)
    assert mc_ops.mrd_combine.launches == n0


def test_int8_reduce_scatter_on_the_card_equals_the_cpu(cuda):
    """The compressed reduce-scatter at dp 3 and dp 6: quantize, permute and
    the kernel's combine on the card give the CPU's plain result bit for bit."""
    from repro_torch.collectives import plans, transforms

    rng = np.random.default_rng(4)
    for p, n in ((3, 512 * 9), (6, 1024 * 5)):
        x = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32) * 3)
        q, s = transforms.quantize(x.to(cuda))
        rq, rs = transforms.quantize(x)
        assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)
        plan = plans.reduce_scatter_plan(p=p, transform="int8")
        n0 = mc_ops.mrd_combine.launches
        out = plan.run(x.to(cuda))
        assert mc_ops.mrd_combine.launches > n0
        assert torch.equal(out.cpu(), plan.run(x))


# --- flash_attention --------------------------------------------------------

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, visible_mask  # noqa: E402

# (B, Sq, Skv, H, KV, hd, causal, window, q_offset): the gemma3 smoke shape
# (local and global layers), llama full width, gemma3 full width with and
# without its 1024 window, hd 128 bidirectional at rep 1, a decode-style
# offset query block at rep 4; then every other bf16 instance (hd 16, 64,
# 128, 256 x rep 1, 2, 4) with the edges of the kernel's tiling: q tiles of
# 128 rows / rep and key tiles of 64 (hd 256) or 128 keys that end partway,
# windows that cut through a key tile, q_offset with a window, and query
# blocks whose rows see no key (they write 0)
FLASH_CASES = [
    (2, 40, 40, 4, 2, 16, True, 16, 0),
    (2, 40, 40, 4, 2, 16, True, None, 0),
    (1, 300, 300, 32, 8, 64, True, None, 0),
    (1, 1100, 1100, 16, 8, 256, True, 1024, 0),
    (1, 1100, 1100, 16, 8, 256, True, None, 0),
    (2, 77, 130, 4, 4, 128, False, None, 0),
    (1, 5, 70, 8, 2, 64, True, 48, 65),
    (1, 150, 150, 2, 2, 16, True, 40, 0),
    (2, 70, 90, 8, 2, 16, False, 33, 0),
    (1, 260, 200, 4, 4, 64, True, None, 60),
    (2, 129, 129, 8, 4, 64, True, 100, 0),
    (1, 200, 100, 4, 2, 64, True, 64, 90),
    (1, 333, 333, 8, 4, 128, True, 200, 0),
    (1, 100, 257, 8, 2, 128, True, 150, 157),
    (1, 517, 517, 4, 4, 256, True, 300, 0),
    (1, 90, 200, 16, 4, 256, False, None, 0),
    (1, 40, 70, 4, 1, 256, True, 16, 300),
    # rep 5 and 7 (dead rows past floor(64 / rep) positions a warpgroup) at
    # every hd: partial q tiles (24 and 18 positions a block in bf16, 6 and
    # 4 in fp32) and key tiles, q_offset with a window, bidirectional, rows
    # that see no key; then qwen2.5-32b's and internvl2-1b's served heads
    (1, 100, 100, 5, 1, 16, True, None, 0), (2, 37, 60, 10, 2, 64, False, None, 0),
    (1, 50, 150, 5, 1, 128, True, 40, 100), (1, 61, 61, 10, 2, 256, True, 20, 0),
    (1, 77, 77, 7, 1, 16, True, 30, 0), (2, 19, 19, 14, 2, 64, True, None, 0),
    (1, 130, 90, 7, 1, 128, False, 33, 0), (1, 40, 70, 7, 1, 256, True, 16, 300),
    (1, 30, 200, 14, 2, 64, True, 8, 150), (1, 25, 50, 5, 1, 64, True, 4, 100),
    (1, 300, 300, 40, 8, 128, True, None, 0), (1, 256, 256, 14, 2, 64, True, None, 0),
    # hd 80 (zamba2-2.7b's shared block, 32/32 heads; bf16 in five 16-column
    # boxes) at every rep with the same edges, then the smoke configs' hd 8
    # and 12 (fp32 natively; bf16 padded to hd 16 by the wrapper)
    (1, 300, 300, 32, 32, 80, True, None, 0), (2, 129, 200, 4, 4, 80, True, 100, 71),
    (1, 77, 130, 4, 2, 80, False, None, 0), (1, 100, 257, 8, 2, 80, True, 150, 157),
    (1, 50, 150, 5, 1, 80, True, 40, 100), (1, 40, 70, 7, 1, 80, True, 16, 300),
    (2, 40, 40, 14, 2, 8, True, None, 0), (1, 60, 60, 7, 1, 8, True, 16, 0),
    (2, 40, 40, 6, 6, 12, True, None, 0), (1, 45, 90, 12, 6, 12, False, 20, 0),
]


def _flash_inputs(seed, B, Sq, Skv, H, KV, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
            for sh in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype, atol):
    """fp32 within 1e-4 (summation order only; CUDA cores, no TF32); bf16
    within 2e-2 of the plain version computed in fp32 on the same bf16
    inputs (P rounded to bf16 before P.V, output rounding to bf16).  Each
    (token, head) row also within a relative error of 1e-4 (fp32) or 1e-2
    (bf16) of the plain row: late causal rows are small, an atol alone
    would not see their errors.  A query that sees no key writes exactly 0
    (the plain version's softmax over masked scores would average v)."""
    B, Sq, Skv, H, KV, hd, causal, window, q_offset = case
    q, k, v = _flash_inputs(0, B, Sq, Skv, H, KV, hd, getattr(torch, dtype), cuda)
    n0 = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape and torch.isfinite(out).all()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window,
                              q_offset=q_offset)
    seen = visible_mask(Sq, Skv, causal, window, q_offset, device=cuda).any(-1)
    assert torch.equal(out[:, ~seen], torch.zeros_like(out[:, ~seen]))
    out, ref = out[:, seen].float(), ref[:, seen]
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)
    if seen.any():
        row_err = ((out - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
        assert row_err <= {"float32": 1e-4, "bfloat16": 1e-2}[dtype], row_err


def test_flash_attention_takes_strided_views(cuda):
    """The model hands the kernel q/k/v views after RoPE and reshapes."""
    q, k, v = _flash_inputs(1, 2, 33, 33, 8, 4, 64, torch.bfloat16, cuda)
    out = fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k[:, :, :],
                                 v, causal=True)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)


def test_flash_attention_refuses_what_it_does_not_take_on_the_card(cuda):
    """No fallback to the plain version for a CUDA tensor."""
    q, k, v = _flash_inputs(2, 1, 8, 8, 4, 2, 32, torch.float32, cuda)  # head dim 32
    n0 = fa_ops.flash_attention.launches
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v)
    q, k, v = _flash_inputs(2, 1, 8, 8, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.detach(), k, v, window=0)
    assert fa_ops.flash_attention.launches == n0


# --- rmsnorm ----------------------------------------------------------------

from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402


@pytest.mark.parametrize("x_dtype,w_dtype,atol", [
    ("float32", "float32", 1e-5), ("bfloat16", "bfloat16", 2e-2), ("bfloat16", "float32", 2e-2)])
@pytest.mark.parametrize("T,d", [(4, 3840), (2048, 3840), (7, 64), (8, 2048), (33, 2048), (5, 8)])
def test_rmsnorm_matches_plain(cuda, T, d, x_dtype, w_dtype, atol):
    """fp32 within 1e-5 (summation order of the row's sum of squares);
    bf16 within 2e-2 (one bf16 rounding of the output)."""
    rng = np.random.default_rng(T * d)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32) * 3).to(
        cuda, getattr(torch, x_dtype))
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32) * 0.1).to(
        cuda, getattr(torch, w_dtype))
    n0 = rn_ops.rmsnorm.launches
    out = rn_ops.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rn_ops.rmsnorm.launches == n0 + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    ref = rmsnorm_ref(x.float(), w.float(), 1e-6)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=atol)


def test_rmsnorm_refuses_what_it_does_not_take_on_the_card(cuda):
    """No fallback to the plain version for a CUDA tensor."""
    x = torch.randn(4, 64, device=cuda)
    w = torch.zeros(64, device=cuda)
    n0 = rn_ops.rmsnorm.launches
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(x[:, :60], w[:60])  # d % 8
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(x, w.cpu())
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(x, w.clone().requires_grad_())
    with pytest.raises(TypeError):
        rn_ops.rmsnorm(x.half(), w)
    assert rn_ops.rmsnorm.launches == n0


# --- selective_scan ---------------------------------------------------------

from repro_torch.kernels.selective_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_ref,
    selective_scan_ref,
)

# (B, S, D, N): the reference's kernel test shapes, then S across several
# staged chunks with a ragged last one, and D not a multiple of a block's
# channels
SCAN_CASES = [(1, 64, 16, 8), (2, 128, 32, 16), (1, 96, 64, 4), (2, 300, 512, 16),
              (3, 77, 80, 16)]
# (B, S, D, N): the smoke config's prompt, the full width's decode tick (one
# step from the state), a prompt at full width with a ragged last chunk
FUSED_CASES = [(2, 40, 128, 8), (8, 1, 8192, 16), (1, 333, 8192, 16)]


def _close(out, ref):
    """|out - ref| <= 1e-5 + 1e-4 |ref|: both sides compute in fp32 from the
    same inputs (FMA contraction, expf and the order of the N-way sum)."""
    assert out.dtype == torch.float32 and out.shape == ref.shape
    bad = ((out - ref).abs() > 1e-5 + 1e-4 * ref.abs()).sum().item()
    assert bad == 0, f"{bad} elements off, max abs err {(out - ref).abs().max().item()}"


def _scan_inputs(seed, B, S, D, N, dtype, device):
    rng = np.random.default_rng(seed)
    decay = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D, N))))
    arrs = [decay, rng.standard_normal((B, S, D, N)) * 0.1, rng.standard_normal((B, S, N)),
            rng.standard_normal((B, D, N)) * 0.5]
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype if i < 3 else torch.float32)
            for i, a in enumerate(arrs)]


def _fused_inputs(seed, B, S, D, N, dtype, device):
    """The block's inputs at model-like scales: dt = softplus(N(-4, 1)) fp32,
    x, Bs, Cs ~ N(0, 1) in ``dtype``, A = -(1..N), h0 ~ 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)) - 4.0))
    A = -np.broadcast_to(np.arange(1, N + 1), (D, N))
    f32 = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
           for a in (dt, A, rng.standard_normal((B, D, N)) * 0.5)]
    typed = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
             for sh in ((B, S, D), (B, S, N), (B, S, N))]
    return f32[0], typed[0], f32[1], typed[1], typed[2], f32[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_selective_scan_matches_plain(cuda, case, dtype):
    """The materialized form (the Pallas kernel's contract), with and
    without h0, against the plain version on the same inputs."""
    decay, bx, cs, h0 = _scan_inputs(0, *case, getattr(torch, dtype), cuda)
    for init in (None, h0):
        n0 = ss_ops.selective_scan.launches
        y, h = ss_ops.selective_scan(decay, bx, cs, h0=init)
        torch.cuda.synchronize()
        assert ss_ops.selective_scan.launches == n0 + 1
        ry, rh = selective_scan_ref(decay, bx, cs, h0=init)
        _close(y, ry)
        _close(h, rh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_selective_scan_fused_matches_plain(cuda, case, dtype):
    """The fused form (the model's path: decay and bx formed in the kernel)
    from a nonzero h0 against the fused plain version."""
    dt, x, A, Bs, Cs, h0 = _fused_inputs(1, *case, getattr(torch, dtype), cuda)
    n0 = ss_ops.selective_scan.launches
    y, h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=h0)
    torch.cuda.synchronize()
    assert ss_ops.selective_scan.launches == n0 + 1
    ry, rh = selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=h0)
    _close(y, ry)
    _close(h, rh)


@pytest.mark.parametrize("case", FUSED_CASES[:2])
def test_selective_scan_fused_updates_the_state_in_place(cuda, case):
    """A decode tick's call: ``h_final`` is ``h0`` itself and a batch where
    ``write_ok`` is False keeps its state; y and the written rows hold to
    the plain version, the kept rows are bit for bit the old state."""
    dt, x, A, Bs, Cs, h0 = _fused_inputs(3, *case, torch.bfloat16, cuda)
    write_ok = torch.arange(case[0], device=cuda) % 2 == 0
    ry, rh = selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=h0)
    state = h0.clone()
    n0 = ss_ops.selective_scan.launches
    y, h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=state, h_final=state,
                                       write_ok=write_ok)
    torch.cuda.synchronize()
    assert ss_ops.selective_scan.launches == n0 + 1 and h is state
    _close(y, ry)
    _close(state[write_ok], rh[write_ok])
    assert torch.equal(state[~write_ok], h0[~write_ok])


def test_selective_scan_refuses_what_it_does_not_take_on_the_card(cuda):
    """No fallback to the plain version for a CUDA tensor."""
    decay, bx, cs, h0 = _scan_inputs(2, 1, 8, 16, 8, torch.float32, cuda)
    dt, x, A, Bs, Cs, fh0 = _fused_inputs(2, 1, 8, 16, 8, torch.float32, cuda)
    n0 = ss_ops.selective_scan.launches
    with pytest.raises(ValueError):  # N = 2
        ss_ops.selective_scan(decay[..., :2].contiguous(), bx[..., :2].contiguous(),
                              cs[..., :2].contiguous())
    with pytest.raises(TypeError):
        ss_ops.selective_scan(decay.half(), bx.half(), cs.half())
    with pytest.raises(ValueError):
        ss_ops.selective_scan(decay, bx, cs, h0=h0.cpu())
    with pytest.raises(ValueError):
        ss_ops.selective_scan(decay, bx.clone().requires_grad_(), cs)
    with pytest.raises(TypeError):
        ss_ops.selective_scan_fused(dt.bfloat16(), x, A, Bs, Cs)
    with pytest.raises(ValueError):
        ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=fh0[:, :8])
    with pytest.raises(ValueError):
        ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=fh0, h_final=fh0.cpu())
    with pytest.raises(ValueError):
        ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=fh0,
                                    write_ok=torch.ones(1, dtype=torch.uint8, device=cuda))
    assert ss_ops.selective_scan.launches == n0


# the edges of the chunked instance (chunks of 64 steps, sums over states
# every 16 steps, 32 channels a block) and of the step instance (S = 1), at
# batches 1, 3 and 8 and every N; D = 40 is a whole block and a ragged one
EDGE_S = [1, 2, 31, 32, 33, 255, 256, 257, 4097]


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("S", EDGE_S)
def test_selective_scan_fused_edges_in_place(cuda, S, B, N):
    """bf16 inputs from a nonzero h0, the state written over h0 with
    write_ok alternating: y and the written rows hold to the plain version,
    the others keep their state bit for bit."""
    dt, x, A, Bs, Cs, h0 = _fused_inputs(S * N + B, B, S, 40, N, torch.bfloat16, cuda)
    write_ok = torch.arange(B, device=cuda) % 2 == 0
    ry, rh = selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=h0)
    state = h0.clone()
    n0 = ss_ops.selective_scan.launches
    y, h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=state, h_final=state,
                                       write_ok=write_ok)
    torch.cuda.synchronize()
    assert ss_ops.selective_scan.launches == n0 + 1 and h is state
    _close(y, ry)
    _close(state[write_ok], rh[write_ok])
    assert torch.equal(state[~write_ok], h0[~write_ok])


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("S", EDGE_S)
def test_selective_scan_materialized_edges(cuda, S, N):
    """The materialized form (the chunked instance at every S, S = 1
    included), fp32, from h0."""
    decay, bx, cs, h0 = _scan_inputs(S + N, 3, S, 40, N, torch.float32, cuda)
    y, h = ss_ops.selective_scan(decay, bx, cs, h0=h0)
    ry, rh = selective_scan_ref(decay, bx, cs, h0=h0)
    _close(y, ry)
    _close(h, rh)


@pytest.mark.parametrize("S", [1, 300])
def test_selective_scan_fused_odd_channels_and_unaligned_state(cuda, S):
    """D odd (x's bf16 rows off 4-byte boundaries: staged by 2-byte loads)
    and h0 4 bytes off a 16-byte boundary (the step instance's scalar
    loads)."""
    dt, x, A, Bs, Cs, h0 = _fused_inputs(7, 2, S, 37, 8, torch.bfloat16, cuda)
    flat = torch.zeros(h0.numel() + 1, device=cuda)
    state = flat[1:].view(h0.shape)
    state.copy_(h0)
    ry, rh = selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=h0)
    y, h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=state, h_final=state)
    _close(y, ry)
    _close(state, rh)


@pytest.mark.parametrize("D,dtype", [(36, "bfloat16"), (37, "float32"), (8192, "bfloat16")])
def test_selective_scan_fused_staging_paths(cuda, D, dtype):
    """Rows off 16-byte boundaries, staged element by element (D = 36 in
    bf16: 2-byte loads; D = 37 in fp32: 4-byte copies), and falcon-mamba-7b's
    8,192 channels (16-byte copies), over 600 steps from h0."""
    dt, x, A, Bs, Cs, h0 = _fused_inputs(9, 1, 600, D, 16, getattr(torch, dtype), cuda)
    y, h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=h0)
    ry, rh = selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=h0)
    _close(y, ry)
    _close(h, rh)
