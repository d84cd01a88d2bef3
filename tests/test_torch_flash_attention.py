"""The port's attention against the reference's flash-attention kernel.

Same inputs, made with numpy from a seed, go through the port's
``flash_attention_ref`` and ``models.attention.attention`` (``full``,
``flash_scan`` and ``kernel``, which is the plain version on the CPU) and
through the reference's ``flash_attention_ref``, its Pallas kernel in
interpret mode (as ``tests/test_kernel_flash_attention.py`` runs it) and
its own ``flash_scan``.  Cases cover causal and bidirectional masks,
windows of 16 and 48, a query offset, GQA rep 1/2/4/5/7, head dims
8/12/16/64/80/128/256, and lengths that are not multiples of the chunk.

Tolerances: fp32 atol = rtol = 2e-5 (summation order); bf16 2e-2 (the
two sides round p and the output to bf16 at other places).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_oracle  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, visible_mask  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
CHUNK = 32  # flash_scan tile and Pallas block: every length below is ragged against it

# (B, Sq, Skv, H, KV, hd, causal, window, q_offset)
CASES = {
    "smoke-local": (2, 40, 40, 4, 2, 16, True, 16, 0),
    "smoke-global": (2, 40, 40, 4, 2, 16, True, None, 0),
    "rep1-window48": (1, 100, 100, 4, 4, 64, True, 48, 0),
    "rep4-bidirectional": (1, 160, 160, 8, 2, 64, False, None, 0),
    "hd256": (1, 37, 37, 2, 1, 256, True, None, 0),
    "hd256-window16": (1, 70, 70, 2, 1, 256, True, 16, 0),
    "offset-window48": (1, 9, 75, 4, 2, 64, True, 48, 66),
    "rep4-bidirectional-window48": (1, 50, 130, 4, 1, 16, False, 48, 0),
    "rep5-hd128": (1, 50, 50, 10, 2, 128, True, None, 0),
    "rep5-hd16-bidirectional": (2, 30, 45, 5, 1, 16, False, None, 0),
    "rep7-hd64-offset-window24": (1, 40, 70, 14, 2, 64, True, 24, 30),
    "rep7-hd256": (1, 20, 20, 7, 1, 256, True, None, 0),
    # the reference's own hd 80 case (tests/test_kernel_flash_attention.py),
    # zamba2's shared block (32/32 heads, rep 1) cut to 4 heads, and the smoke
    # configs' heads: internvl2-1b's hd 8 (rep 7), minicpm-2b's hd 12 (rep 1)
    "hd80": (1, 64, 192, 2, 2, 80, True, None, 0),
    "hd80-window48-offset": (1, 40, 90, 4, 4, 80, True, 48, 50),
    "rep7-hd8": (2, 30, 30, 7, 1, 8, True, None, 0),
    "rep1-hd12-window16": (1, 45, 45, 6, 6, 12, True, 16, 0),
}


def _inputs(name, dtype="float32"):
    B, Sq, Skv, H, KV, hd, *_ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in arrs]
    return arrs


def _masks(name):
    causal, window, q_offset = CASES[name][6:]
    return dict(causal=causal, window=window, q_offset=q_offset)


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


@functools.lru_cache(maxsize=None)
def _reference_kernel(name):
    """The reference's Pallas kernel in interpret mode, fp32."""
    out = ref_flash(*_jax(_inputs(name), "float32"), bq=CHUNK, bk=CHUNK, interpret=True,
                    **_masks(name))
    return np.asarray(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_reference_oracle(name, dtype):
    arrs = _inputs(name, dtype)
    ours = flash_attention_ref(*_torch(arrs, dtype), **_masks(name))
    theirs = ref_oracle(*_jax(arrs, dtype), **_masks(name))
    assert ours.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("impl", ["full", "flash_scan", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_matches_reference_kernel(name, impl):
    """fp32: every implementation of the port against the reference's
    Pallas kernel (interpret mode) and, for flash_scan, against the
    reference's own flash_scan (which walks the chunks the port skips)."""
    arrs = _inputs(name)
    n0 = fa_ops.flash_attention.launches
    ours = attn.attention(*_torch(arrs, "float32"), impl=impl, chunk=CHUNK, **_masks(name))
    assert fa_ops.flash_attention.launches == n0  # the CPU runs the plain version
    np.testing.assert_allclose(ours.numpy(), _reference_kernel(name), **TOL["float32"])
    if impl == "flash_scan":
        theirs = ref_attention.attention(*_jax(arrs, "float32"), impl="flash_scan",
                                         chunk=CHUNK, **_masks(name))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL["float32"])


@pytest.mark.parametrize("impl", ["full", "flash_scan"])
@pytest.mark.parametrize("name", ["smoke-local", "hd256-window16", "offset-window48"])
def test_attention_bf16_matches_reference(name, impl):
    arrs = _inputs(name, "bfloat16")
    ours = attn.attention(*_torch(arrs, "bfloat16"), impl=impl, chunk=CHUNK, **_masks(name))
    theirs = ref_attention.attention(*_jax(arrs, "bfloat16"), impl=impl, chunk=CHUNK,
                                     **_masks(name))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                               **TOL["bfloat16"])


def test_auto_follows_the_reference_rule_off_the_card():
    """On the CPU, and under autograd, ``auto`` is the reference's rule:
    full up to 2048 keys, flash_scan beyond."""
    q = torch.zeros(1, 4, 2, 16)
    short, long = torch.zeros(1, 2048, 1, 16), torch.zeros(1, 2049, 1, 16)
    assert attn.resolve_impl("auto", q, short, short) == "full"
    assert attn.resolve_impl("auto", q, long, long) == "flash_scan"
    assert attn.resolve_impl("auto", q.requires_grad_(), long, long) == "flash_scan"
    assert attn.resolve_impl("flash_scan", q, short, short) == "flash_scan"
    with pytest.raises(ValueError):
        attn.resolve_impl("pallas", q, short, short)


def test_flash_scan_is_differentiable_like_full():
    """Training on long sequences takes flash_scan under autograd: its
    gradients match the materialized version's."""
    arrs = _inputs("smoke-local")
    grads = {}
    for impl in ("full", "flash_scan"):
        q, k, v = (t.requires_grad_() for t in _torch(arrs, "float32"))
        attn.attention(q, k, v, impl=impl, chunk=CHUNK, **_masks("smoke-local")).square().sum(
        ).backward()
        grads[impl] = [t.grad.numpy() for t in (q, k, v)]
    for a, b in zip(grads["full"], grads["flash_scan"]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


# (Sq, Skv, causal, window, q_offset): square causal with and without a
# window, a decode-style offset block, bidirectional with and without a
# window, queries past the window's reach (some or all see no key), Skv < Sq
PAIR_CASES = [(40, 40, True, None, 0), (40, 40, True, 16, 0), (9, 75, True, 48, 66),
              (50, 130, False, 48, 0), (77, 130, False, None, 0), (200, 100, True, 64, 90),
              (40, 70, True, 16, 300), (33, 17, True, 5, 3), (1, 1, True, 1, 0)]


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset", PAIR_CASES)
def test_visible_pairs_counts_the_reference_mask(Sq, Skv, causal, window, q_offset):
    """The kernel's operation count (chip_smoke.py's bound) is the number of
    True entries of the reference's mask, and of the plain version's."""
    m = ref_attention._mask(q_offset + jnp.arange(Sq), jnp.arange(Skv), causal=causal,
                            window=window)
    n = fa_ops.visible_pairs(Sq, Skv, causal, window, q_offset)
    assert n == int(np.asarray(m).sum())
    assert n == int(visible_mask(Sq, Skv, causal, window, q_offset).sum())
