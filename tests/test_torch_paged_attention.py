"""The port's paged decode attention against the reference's.

On the CPU the port's wrapper runs its plain version
(``repro_torch.kernels.paged_attention.ref``); it is held against the
reference's plain oracle and against the reference's Pallas kernel in
interpret mode, on the reference test's shape grid, ragged lengths
(including 1 and full) and permuted physical blocks, at the reference
test's own tolerance (atol = rtol = 1e-5, fp32).  The CUDA kernel itself
runs only on a card: ``test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import paged_attention as ref_kernel  # noqa: E402
from repro.kernels.flash_attention.ref import paged_attention_ref as ref_oracle  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

GRID = [
    (3, 4, 4, 64, 3, 8),  # MHA
    (4, 8, 2, 64, 2, 8),  # GQA 4:1
    (2, 6, 3, 80, 4, 16),  # odd head dim, bigger blocks
    (1, 2, 1, 32, 2, 4),  # single sequence, tiny blocks
    (8, 32, 8, 64, 7, 16),  # llama3.2-1b full width, the served shape
    (8, 4, 2, 16, 3, 8),  # llama3.2-1b smoke
    (8, 40, 8, 128, 5, 16),  # qwen2.5-32b / llama4-scout heads: rep 5, hd 128
    (4, 14, 2, 64, 3, 16),  # internvl2-1b: rep 7
    (3, 7, 1, 128, 4, 8),  # rep 7, hd 128
    (4, 32, 32, 80, 3, 16),  # zamba2-2.7b's shared block: 32/32 heads at hd 80
    (3, 7, 1, 8, 3, 8),  # internvl2-1b smoke: rep 7, hd 8
    (2, 6, 6, 12, 3, 8),  # minicpm-2b smoke: rep 1, hd 12
]
NEW = GRID[6:]  # the widths added with the qwen2.5 / internvl2 / moe / zamba2 configs


def _mk(seed, *, S, H, KV, hd, nb, bs):
    """Random q + pools + a disjoint table over permuted physical blocks,
    ragged lengths with a full row and (S > 1) a length-1 row."""
    rng = np.random.default_rng(seed)
    N = S * nb + 1
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k = rng.standard_normal((N, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((N, bs, KV, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[: S * nb].reshape(S, nb).astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, size=S).astype(np.int32)
    lengths[0] = nb * bs
    if S > 1:
        lengths[-1] = 1
    return q, k, v, tables, lengths


def _port(q, k, v, tables, lengths):
    out = ops.paged_attention(*(torch.from_numpy(a) for a in (q, k, v, tables, lengths)))
    return out.numpy()


@pytest.mark.parametrize("S,H,KV,hd,nb,bs", GRID)
def test_plain_matches_reference_oracle(S, H, KV, hd, nb, bs):
    args = _mk(0, S=S, H=H, KV=KV, hd=hd, nb=nb, bs=bs)
    ref = ref_oracle(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(_port(*args), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S,H,KV,hd,nb,bs", GRID[:4] + NEW)
def test_plain_matches_reference_pallas_interpret(S, H, KV, hd, nb, bs):
    args = _mk(1, S=S, H=H, KV=KV, hd=hd, nb=nb, bs=bs)
    ref = ref_kernel(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(_port(*args), np.asarray(ref), **TOL)


def test_invariant_under_physical_permutation():
    q, k, v, tables, lengths = _mk(3, S=2, H=4, KV=2, hd=32, nb=3, bs=8)
    out0 = _port(q, k, v, tables, lengths)
    rng = np.random.default_rng(4)
    perm = np.concatenate([[0], rng.permutation(np.arange(1, k.shape[0]))])
    inv = np.argsort(perm)
    out1 = _port(q, k[perm], v[perm], inv[tables].astype(np.int32), lengths)
    np.testing.assert_allclose(out0, out1, atol=1e-6, rtol=1e-6)


def test_garbage_beyond_length_is_ignored():
    q, k, v, tables, lengths = _mk(5, S=2, H=2, KV=2, hd=32, nb=2, bs=8)
    lengths = np.array([5, 12], np.int32)
    out0 = _port(q, k, v, tables, lengths)
    k2, v2 = k.copy(), v.copy()
    for s, L in enumerate(lengths):
        for p in range(L, 2 * 8):
            k2[tables[s, p // 8], p % 8] = 1e9
            v2[tables[s, p // 8], p % 8] = -1e9
    np.testing.assert_allclose(out0, _port(q, k2, v2, tables, lengths), atol=1e-6, rtol=1e-6)


def test_plain_keeps_bf16_type():
    q, k, v, tables, lengths = _mk(6, S=3, H=4, KV=2, hd=16, nb=2, bs=8)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, lengths)]
    bf = [x.bfloat16() if x.is_floating_point() else x for x in t]
    out = paged_attention_ref(*bf)
    assert out.dtype == torch.bfloat16
    ref = paged_attention_ref(*[x.float() if x.is_floating_point() else x for x in bf])
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


@pytest.mark.parametrize(
    "change, err",
    [
        (dict(hd=32), ValueError),  # head dim the kernel does not take
        (dict(H=6, KV=2), ValueError),  # rep 3
        (dict(bs=4), ValueError),  # block size
        (dict(dtype=torch.float16), TypeError),
        (dict(tables_dtype=torch.int64), TypeError),
        (dict(noncontig=True), ValueError),
    ],
)
def test_kernel_input_checks_raise(change, err):
    shape = dict(S=2, H=4, KV=2, hd=16, nb=2, bs=8)
    shape.update({k: v for k, v in change.items() if k in shape})
    q, k, v, tables, lengths = (torch.from_numpy(a) for a in _mk(7, **shape))
    dt = change.get("dtype", torch.float32)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    tables = tables.to(change.get("tables_dtype", torch.int32))
    if change.get("noncontig"):
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(err):
        ops.check_inputs(q, k, v, tables, lengths)


def test_kernel_input_checks_accept_served_shapes():
    for S, H, KV, hd, nb, bs in (GRID[4], GRID[5], *NEW):
        args = [torch.from_numpy(a) for a in _mk(8, S=S, H=H, KV=KV, hd=hd, nb=nb, bs=bs)]
        ops.check_inputs(*args)
        ops.check_inputs(*[a.bfloat16() if a.is_floating_point() else a for a in args])


# --- the kernel's split over positions (v2), modelled in plain torch --------

from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_partials,
    paged_attention_split_ref,
)


def _splits_of(nb):
    """Splits of 1 page, 2 pages and more pages than the table has."""
    return [1, 2, nb + 1]


def _split_model(args, pages):
    t = [torch.from_numpy(a) for a in args]
    return paged_attention_split_ref(*t, pages).numpy()


@pytest.mark.parametrize("S,H,KV,hd,nb,bs", GRID)
@pytest.mark.parametrize("which", range(3))
def test_split_model_matches_plain_and_reference_oracle(S, H, KV, hd, nb, bs, which):
    args = _mk(0, S=S, H=H, KV=KV, hd=hd, nb=nb, bs=bs)
    got = _split_model(args, _splits_of(nb)[which])
    np.testing.assert_allclose(got, _port(*args), **TOL)
    np.testing.assert_allclose(got, np.asarray(ref_oracle(*(jnp.asarray(a) for a in args))),
                               **TOL)


@pytest.mark.parametrize("S,H,KV,hd,nb,bs", GRID[:4])
@pytest.mark.parametrize("which", range(3))
def test_split_model_matches_reference_pallas_interpret(S, H, KV, hd, nb, bs, which):
    args = _mk(1, S=S, H=H, KV=KV, hd=hd, nb=nb, bs=bs)
    ref = ref_kernel(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(_split_model(args, _splits_of(nb)[which]), np.asarray(ref), **TOL)


def test_split_model_empty_splits_and_short_rows():
    """Lengths 1, a page multiple and one past it: a split wholly past a
    length is the empty partial (m = -1e30, l = 0, acc = 0) and drops out
    of the merge."""
    q, k, v, tables, _ = _mk(9, S=4, H=4, KV=2, hd=16, nb=6, bs=8)
    lengths = np.array([1, 16, 17, 48], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, lengths)]
    m, l, acc = paged_attention_partials(*t, 2)  # splits of 16 positions
    assert m.shape == (4, 4, 3) and acc.shape == (4, 4, 3, 16)
    live = np.array([[1, 0, 0], [1, 0, 0], [1, 1, 0], [1, 1, 1]], bool)
    for s in range(4):
        for j in range(3):
            if live[s, j]:
                assert (m[s, :, j] > -1e29).all() and (l[s, :, j] > 0).all()
            else:
                assert (m[s, :, j] == -1e30).all() and (l[s, :, j] == 0).all()
                assert (acc[s, :, j] == 0).all()
    np.testing.assert_allclose(paged_attention_split_ref(*t, 2).numpy(),
                               _port(q, k, v, tables, lengths), **TOL)


@pytest.mark.parametrize(
    "nb, bs, pages, splits",
    [(7, 16, 16, 1),     # the served llama3.2-1b table: one split, no merge
     (16, 16, 16, 1),    # 256 positions: still one
     (17, 16, 16, 2),
     (256, 16, 16, 16),  # 4,096 positions
     (3, 8, 32, 1), (33, 8, 32, 2), (512, 8, 32, 16)],
)
def test_split_plan_is_a_function_of_the_table_width(nb, bs, pages, splits):
    assert ops.split_plan(nb, bs) == (pages, splits)
    assert ops.workspace_numel(8, 32, 64, splits) == (0 if splits == 1 else
                                                      8 * 32 * splits * 66)


def test_unaligned_pools_are_realigned_not_refused():
    """The kernel reads q and the pools with 16-byte loads: a pool 4 bytes
    past a 16-byte boundary passes the checks and goes to the kernel as an
    aligned copy of the same values; an aligned one goes as itself."""
    args = [torch.from_numpy(a) for a in _mk(10, S=2, H=4, KV=2, hd=16, nb=2, bs=8)]
    flat = torch.zeros(args[1].numel() + 1)
    shifted = flat[1:].view(args[1].shape)  # 4 bytes past a 16-byte boundary
    shifted.copy_(args[1])
    ops.check_inputs(args[0], shifted, args[2], args[3], args[4])
    moved = ops.aligned(shifted)
    assert moved.data_ptr() % ops.ALIGN == 0 and torch.equal(moved, args[1])
    assert ops.aligned(args[1]) is args[1]
