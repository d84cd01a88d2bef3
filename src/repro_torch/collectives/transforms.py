"""Payload transforms (port of ``repro.collectives.transforms``).

A transform decides what each reducing stage (``bshift``/``butterfly``/
``rs``) puts on the wire and how the receiver folds it back in; copy
stages (``fshift``/``ag``) always travel raw.

- ``identity``: the payload is the buffer itself; combine is the plan's op.
- ``int8``: blockwise int8 quantization (one fp32 scale per ``block``
  values, 256 by default: wire bytes / 4 against fp32, plus 1.6% of
  scales) with dequant-accumulate on receive, which the executor hands to
  the ``mrd_combine`` kernel for 256-blocks on a CUDA tensor.  Sum only.
  The grad-sync layer compensates the first hop with the EF-SGD residual
  carry (:func:`ef_roundtrip`).

The functions here take the rank axis as leading batch dimensions: a
stacked ``[p, n]`` buffer quantizes row by row, as the reference's
``vmap`` over ranks does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

BLOCK = 256


def quantize(x, block: int = BLOCK):
    """x: [..., n] float -> (q int8 [..., n], scales f32 [..., n/block]);
    n % block == 0.  Divides by the scale (no reciprocal) and rounds half
    to even, as the reference does."""
    n = x.shape[-1]
    if n % block:
        raise ValueError(f"quantize needs n % {block} == 0, got n={n}")
    xb = x.float().reshape(*x.shape[:-1], n // block, block)
    amax = torch.linalg.vector_norm(xb, ord=float("inf"), dim=-1, keepdim=True)  # max |x|
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which can differ from true division in the last bit
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    q = torch.div(xb, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def dequantize(q, scales, block: int = BLOCK):
    n = q.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], n // block, block).mul_(scales[..., None])
    return xb.reshape(q.shape)


def quantization_error(x, block: int = BLOCK):
    q, s = quantize(x, block)
    return x.float() - dequantize(q, s, block)


def wire_bytes_factor(dtype_bytes: int = 4, block: int = BLOCK) -> float:
    """Bytes-on-wire ratio of compressed vs uncompressed payloads."""
    return (1.0 + 4.0 / block) / dtype_bytes


def ef_roundtrip(x, ef, block: int = BLOCK):
    """EF-SGD error feedback for a quantized send: compress what was meant
    to be sent (``x + ef``) and remember what the grid dropped.

    Returns ``(sendable, new_ef)``: ``sendable`` is the quantization-grid
    round trip of ``x + ef`` and ``new_ef = (x + ef) - sendable``."""
    want = x.float() + ef
    sendable = dequantize(*quantize(want, block), block)
    return sendable, want - sendable


def ef_roundtrip_(x, ef, block: int = BLOCK):
    """:func:`ef_roundtrip` in place, for an fp32 ``x`` the caller gives up:
    ``x`` becomes ``x + ef`` and ``ef`` receives the new residual; returns
    ``sendable``.  The same values bit for bit, without the two extra
    copies of the buffer (3.2 GB each for the largest full-width bucket
    at dp 3)."""
    want = x.add_(ef)
    sendable = dequantize(*quantize(want, block), block)
    torch.sub(want, sendable, out=ef)
    return sendable


class IdentityTransform:
    """Raw payloads; combine = the plan's reduction op."""

    name = "identity"
    quantum = 1  # buffer-length divisibility the transform needs

    def validate_op(self, op: str | Callable):
        pass

    def encode(self, x, be):
        return (x,)

    def canonicalize(self, x, be):
        """The value a partner reconstructs from this rank's payload (the
        buffer itself for a lossless format)."""
        return x

    def combine(self, keep, payload, op: Callable, be):
        (recv,) = payload
        return op(keep, recv)


@dataclasses.dataclass(frozen=True)
class Int8BlockwiseTransform:
    """Blockwise int8 wire format; combine = dequant-accumulate (sum only),
    delegated to the backend's ``combine_quantized`` (the kernel for
    256-blocks on the card)."""

    block: int = BLOCK
    name: str = "int8"

    @property
    def quantum(self) -> int:
        return self.block

    def validate_op(self, op: str | Callable):
        if op != "sum" and op is not torch.add:
            raise ValueError(
                f"transform 'int8' only supports op='sum' (dequant-accumulate), got {op!r}"
            )

    def encode(self, x, be):
        return be.vmap_ranks(lambda v: quantize(v, self.block))(x)

    def canonicalize(self, x, be):
        return be.vmap_ranks(lambda v: dequantize(*quantize(v, self.block), self.block))(x)

    def combine(self, keep, payload, op: Callable, be):
        q, scales = payload
        return be.combine_quantized(keep, q, scales, self.block)


TRANSFORMS: dict[str, Callable[..., Any]] = {}


def register_transform(name: str):
    def deco(factory):
        TRANSFORMS[name] = factory
        return factory

    return deco


register_transform("identity")(lambda **kw: IdentityTransform())
register_transform("int8")(lambda block=BLOCK, **kw: Int8BlockwiseTransform(block))


def resolve_transform(transform, **kw):
    """Accept a name, a transform instance, or None (identity)."""
    if transform is None:
        return IdentityTransform()
    if isinstance(transform, str):
        try:
            return TRANSFORMS[transform](**kw)
        except KeyError:
            raise ValueError(
                f"unknown transform {transform!r}; registered: {sorted(TRANSFORMS)}"
            ) from None
    return transform
