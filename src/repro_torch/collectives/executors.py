"""Executors (port of ``repro.collectives.executors``, the sim backend).

:class:`SimBackend` runs a schedule's stages on a stacked tensor
``[p, ...]`` (one row per rank) on a single device, so the MRD math is
exercised for any ``p`` without ``p`` processes.  Its int8 combine
(``keep + dequant(q, scales)``) runs the ``mrd_combine`` CUDA kernel over
the flattened rows of a CUDA tensor (the plain version on the CPU): the
sim executor on the card does what the reference's ``device_fused``
executor does on a TPU.  The reference's ``device``/``device_fused``
executors (collective-permute across chips) become ``torch.distributed``
point-to-point ops in a later slice.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels.mrd_combine import mrd_combine
from repro_torch.kernels.mrd_combine.ref import QBLOCK

OPS: dict[str, Callable[[Any, Any], Any]] = {
    "sum": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
}


def resolve_op(op: str | Callable) -> Callable:
    if callable(op):
        return op
    try:
        return OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduction op {op!r}; known: {sorted(OPS)}") from None


@functools.lru_cache(maxsize=4096)
def _sim_gather_spec(p: int, pairs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(p, pairs, device) source index of each rank and the mask of the
    ranks that receive nothing, made once: building them from Python lists
    on every call would copy them to the card, and each such copy waits
    for the card."""
    idx = [0] * p
    idle = [True] * p
    for s, d in pairs:
        idx[d] = s
        idle[d] = False
    return torch.tensor(idx, device=device), torch.tensor(idle, device=device)


class SimBackend:
    """Executes stages on stacked tensors [p, ...] on one device."""

    def __init__(self, p: int):
        self.p = p

    def rank(self, device=None):
        return torch.arange(self.p, device=device)

    def permute(self, x, pairs):
        """Rank ``d`` receives rank ``s``'s row for each (s, d); ranks that
        receive nothing get zeros."""
        idx, idle = _sim_gather_spec(self.p, tuple(pairs), x.device)
        return x[idx].masked_fill_(idle.reshape((self.p,) + (1,) * (x.ndim - 1)), 0)

    def where(self, mask, a, b, out=None):
        """Rows of ``a`` where ``mask`` [p] holds, else of ``b``.  ``out``
        may be ``a`` itself, a buffer the caller owns: the selection then
        runs in place and allocates nothing."""
        mask = torch.as_tensor(mask, device=a.device)
        nd = max(a.ndim, b.ndim)
        mask = mask.reshape(mask.shape + (1,) * (nd - mask.ndim))
        return torch.where(mask, a, b, out=out)

    # value-dimension helpers (the rank axis leads, values trail)
    def split_half(self, x):
        n = x.shape[1]
        return x[:, : n // 2], x[:, n // 2 :]

    def concat(self, a, b):
        return torch.cat([a, b], dim=1)

    def vmap_ranks(self, fn: Callable) -> Callable:
        """Lift a per-rank function to the stacked layout: the port's
        per-rank functions (``transforms.quantize`` & co.) already take the
        rank axis as a leading batch dimension."""
        return fn

    def combine_quantized(self, x, q, scales, block: int):
        """``x + dequant(q, scales)`` on ``[p, len]`` rows, as one call of
        the ``mrd_combine`` kernel over the flattened ``[p * len]`` rows
        (every row is a whole number of 256-blocks, so the flat scales
        ``[p * len / 256]`` line up)."""
        if block != QBLOCK:
            raise ValueError(f"combine_quantized takes {QBLOCK}-element blocks, got {block}")
        out = mrd_combine(x.reshape(-1), q.reshape(-1), scales.reshape(-1))
        return out.reshape(x.shape)


EXECUTORS: dict[str, Callable[..., Any]] = {}


def register_executor(name: str):
    def deco(factory):
        EXECUTORS[name] = factory
        return factory

    return deco


def make_backend(executor: str, *, p: Optional[int] = None):
    """Instantiate a registered executor bound to a sim rank count."""
    try:
        factory = EXECUTORS[executor]
    except KeyError:
        raise ValueError(
            f"unknown executor {executor!r}; registered: {sorted(EXECUTORS)}"
        ) from None
    return factory(p=p)


@register_executor("sim")
def _sim(p=None):
    if p is None:
        raise ValueError("executor 'sim' needs p")
    return SimBackend(p)
