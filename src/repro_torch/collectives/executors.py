"""Executors (port of ``repro.collectives.executors``, the sim backend).

:class:`SimBackend` runs a schedule's stages on a stacked tensor
``[p, ...]`` (one row per rank) on a single device, so the MRD math is
exercised for any ``p`` without ``p`` processes.  The reference's
``device``/``device_fused`` executors (collective-permute across chips)
become ``torch.distributed`` point-to-point ops in a later slice.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

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
def _sim_gather_spec(p: int, pairs) -> tuple[tuple[int, ...], tuple[bool, ...]]:
    """Per-(p, pairs) source index and receive mask of each rank."""
    idx = [0] * p
    has = [False] * p
    for s, d in pairs:
        idx[d] = s
        has[d] = True
    return tuple(idx), tuple(has)


class SimBackend:
    """Executes stages on stacked tensors [p, ...] on one device."""

    def __init__(self, p: int):
        self.p = p

    def rank(self, device=None):
        return torch.arange(self.p, device=device)

    def permute(self, x, pairs):
        """Rank ``d`` receives rank ``s``'s row for each (s, d); ranks that
        receive nothing get zeros."""
        idx, has = _sim_gather_spec(self.p, tuple(pairs))
        recv = x[torch.tensor(idx, device=x.device)]
        mask = torch.tensor(has, device=x.device).reshape((self.p,) + (1,) * (x.ndim - 1))
        return torch.where(mask, recv, torch.zeros_like(recv))

    def where(self, mask, a, b):
        mask = torch.as_tensor(mask, device=a.device)
        nd = max(a.ndim, b.ndim)
        mask = mask.reshape(mask.shape + (1,) * (nd - mask.ndim))
        return torch.where(mask, a, b)


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
