"""Shared functional layers: norms, RoPE, the SwiGLU and gelu MLPs,
initializers (port of ``repro.models.layers``).

Same mixed-precision policy as the reference: parameters in
``cfg.param_dtype``, matmuls in ``cfg.compute_dtype``, normalization
statistics and rotary angles in fp32.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import needs_grad
from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers (same distributions as the reference; torch draws other bits)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, *, fan_in: int | None = None, block=None):
    """N(0, 1 / fan_in) in ``dtype``.  A stacked shape (leading layer or
    expert axes before the matrix) is drawn one matrix at a time into a
    tensor of ``dtype``, so the fp32 transient is one matrix (566 MB for
    qwen2.5-32b's w1), not the stack (36 GB).  ``block``, when given, keeps
    a rank's block of the leaf, drawn from the same stream as the whole:
    ``block.lead`` holds a range of each leading axis, and ``block(x)``
    maps each drawn matrix whose leading index lies in them to its part."""
    shape = tuple(shape)
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(fan_in)
    if len(shape) <= 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        x = x.mul_(scale).to(dtype)
        return x if block is None else block(x).clone()
    out = None if block is not None else torch.empty(shape, dtype=dtype, device=gen.device)
    for lead in itertools.product(*map(range, shape[:-2])):
        x = torch.randn(shape[-2:], generator=gen, dtype=torch.float32, device=gen.device)
        if block is None:
            out[lead].copy_(x.mul_(scale))
            continue
        if any(i not in r for i, r in zip(lead, block.lead)):
            continue
        part = block(x)
        if out is None:
            out = torch.empty(tuple(len(r) for r in block.lead) + part.shape, dtype=dtype,
                              device=gen.device)
        out[tuple(i - r.start for i, r in zip(lead, block.lead))].copy_(part.mul_(scale))
    return out


def embed_init(gen: torch.Generator, shape, dtype):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm, stored as w under the (1 + w) convention
# ---------------------------------------------------------------------------


def rmsnorm(x, weight, eps: float = 1e-5):
    """x: [..., d] -> [..., d] in x's type.  On the card, the rmsnorm
    kernel over the rows flattened to [T, d]; on the CPU its plain version.
    The kernel has no backward, so inputs that autograd would differentiate
    (training) take the plain version on any device."""
    if needs_grad(x, weight):
        return rmsnorm_ref(x, weight, eps)
    d = x.shape[-1]
    return rmsnorm_kernel(x.reshape(-1, d).contiguous(), weight, eps).reshape(x.shape)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style half rotation)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] or [S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (x @ W layout, as the reference)
# ---------------------------------------------------------------------------


class Keep:
    """The default ``place`` of the initializers: every leaf whole.
    ``place(name, leaf)`` keeps a made leaf; ``place.dense(name, gen,
    shape, dtype, fan_in=)`` draws a :func:`dense_init` leaf."""

    def __call__(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        return leaf

    def dense(self, name: str, gen, shape, dtype, *, fan_in: int | None = None):
        return dense_init(gen, shape, dtype, fan_in=fan_in)


keep = Keep()


def mlp_init(gen: torch.Generator, lead: tuple, d: int, f: int, dtype,
             act: str = "silu", place=keep) -> dict[str, torch.Tensor]:
    """One layer's MLP (stacked on ``lead`` axes): SwiGLU's ``w1``/``w3``
    [d, f] and ``w2`` [f, d], or, with ``act="gelu"``, ``w1`` and ``w2``
    only.  ``place(name, leaf)`` keeps each leaf as soon as it is drawn
    (a rank's block of it, ``sharding.Placer``)."""
    p = {"w1": place.dense("w1", gen, lead + (d, f), dtype)}
    if act == "silu":
        p["w3"] = place.dense("w3", gen, lead + (d, f), dtype)
    p["w2"] = place.dense("w2", gen, lead + (f, d), dtype, fan_in=f)
    return p


def mlp_apply(lp, x, act: str = "silu"):
    """SwiGLU, ``w2(silu(x w1) * x w3)``; or ``w2(gelu(x w1))`` with the
    tanh approximation, which is ``jax.nn.gelu``'s default (the erf form
    differs by ~1e-3).  Under TP with ``d_ff`` sharded (``sharding``):
    ``w1``/``w3`` column-parallel, ``w2`` row-parallel and the sum over
    ``"model"``."""
    ctx = shd.active()
    if ctx is not None and shd.tp_dim(ctx.cfg.d_ff):
        x = shd.tp_copy(x)
        if act == "silu":
            h = F.silu(x @ lp["w1"]) * (x @ lp["w3"])
        else:
            h = F.gelu(x @ lp["w1"], approximate="tanh")
        return shd.tp_reduce(h @ lp["w2"])
    if act == "silu":
        return (F.silu(x @ lp["w1"]) * (x @ lp["w3"])) @ lp["w2"]
    return F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]
