"""Executors (port of ``repro.collectives.executors``).

A backend knows how to move data between ranks and how to express
rank-dependent selection, nothing about schedules or wire formats:

- :class:`DeviceBackend`: one process a rank, over ``torch.distributed``.
  An axis is a named dimension of a
  :class:`~torch.distributed.device_mesh.DeviceMesh`; a stage's permute is
  one ``batch_isend_irecv`` of point-to-point ops within that dimension's
  group.  The rank is a host integer, so every rank-dependent selection
  picks a buffer on the host and launches nothing.
- :class:`FusedDeviceBackend`: the same, with the int8 combine
  (``keep + dequant(q, scales)``) run by the ``mrd_combine`` CUDA kernel
  whenever the payload tiles its 256-element block.
- :class:`SimBackend`: a stacked tensor ``[p, ...]`` (one row per rank) on
  one device, so the MRD math is exercised for any ``p`` without ``p``
  processes.  Its int8 combine of 256-blocks also runs the kernel, over
  the flattened rows of a CUDA tensor.

Each wrapper of the kernel takes the plain version (``ref.py``) for a CPU
tensor, so every backend runs on the CPU too.

On NCCL (one card a rank: a card holds no two ranks of a communicator;
``tests/test_torch_collectives_nccl.py`` runs these executors on four
cards), :class:`DeviceBackend` keeps three rules: the caller sets
``torch.cuda.set_device`` before the mesh is made; the backend's first
operation on its group is a barrier of every rank of that group, since a
group's first ``batch_isend_irecv`` must involve all its ranks; and a rank
with no op in a stage issues none (``batch_isend_irecv([])`` raises).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch
import torch.distributed as dist

from repro_torch.kernels.mrd_combine import mrd_combine
from repro_torch.kernels.mrd_combine.ref import QBLOCK, mrd_combine_ref

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


@runtime_checkable
class Backend(Protocol):
    """What the plan layer needs from an executor."""

    def rank(self, device=None): ...

    def size(self) -> int: ...

    def permute(self, x, pairs):
        """The received buffer, or an :class:`InFlight` that
        :func:`landed` waits on."""
        ...

    def where(self, mask, a, b, out=None): ...

    def split_half(self, x): ...

    def concat(self, a, b): ...

    def vmap_ranks(self, fn: Callable) -> Callable:
        """Lift a per-rank function to this backend's layout."""
        ...

    def combine_quantized(self, x, q, scales, block: int): ...


def _plain_combine(x, q, scales, block: int):
    """``x + dequant(q, scales)`` in ``x``'s type over the flattened values
    (each row of a stacked ``x`` is a whole number of blocks)."""
    return mrd_combine_ref(x.reshape(-1), q.reshape(-1), scales.reshape(-1), block).reshape(
        x.shape)


@functools.lru_cache(maxsize=4096)
def _peers(rank: int, pairs) -> tuple[tuple[int, ...], Optional[int]]:
    """(ranks ``rank`` sends to, the rank it receives from or None) in one
    stage's pairs."""
    to = tuple(d for s, d in pairs if s == rank)
    frm = [s for s, d in pairs if d == rank]
    if len(frm) > 1:
        raise ValueError(f"rank {rank} receives from {frm} in one stage")
    return to, (frm[0] if frm else None)


class InFlight:
    """A permute's messages in flight: :meth:`wait` waits on them (on NCCL:
    the current stream waits for them) and returns the received buffer.
    The sent buffer is held until then."""

    __slots__ = ("recv", "works", "send")

    def __init__(self, recv, works, send):
        self.recv, self.works, self.send = recv, works, send

    def wait(self):
        for work in self.works:
            work.wait()
        self.works, self.send = (), None
        return self.recv


def landed(x):
    """``x`` with every :class:`InFlight` in it (one, or a tuple of them)
    waited on and replaced by its received buffer; anything else as it
    is."""
    if isinstance(x, InFlight):
        return x.wait()
    if isinstance(x, tuple):
        return tuple(landed(v) for v in x)
    return x


def axis_ranks(mesh, axis: str) -> tuple[int, list]:
    """(this process's coordinate along the dimension ``axis`` of
    ``mesh``, the global ranks along it in coordinate order).  A mesh over
    ranks out of order (the elastic trainer's, whose joiners come last)
    numbers its ranks by place, where its process group numbers them in
    sorted order."""
    d = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    where = tuple(coord[:d]) + (slice(None),) + tuple(coord[d + 1:])
    return coord[d], [int(r) for r in mesh.mesh[where].tolist()]


class DeviceBackend:
    """Executes stages on rank-local 1-D buffers across processes, within
    the group of one named dimension of ``mesh``; a rank is its
    coordinate along that dimension (:func:`axis_ranks`)."""

    def __init__(self, axis: str, mesh):
        self.axis = axis
        self.group = mesh.get_group(axis)
        self._rank, self._global = axis_ranks(mesh, axis)
        self._size = len(self._global)
        dist.barrier(group=self.group)  # the group's first operation: every rank

    def rank(self, device=None) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    def permute(self, x, pairs) -> InFlight:
        """Send ``x`` to every ``d`` of a pair ``(me, d)`` and receive from
        ``s`` of the pair ``(s, me)``; a rank that receives nothing gets
        zeros, as ``ppermute`` gives.  A rank with no op issues none.  The
        messages are issued and not waited on: a stage waits at its finish
        (:func:`landed`), so on NCCL the compute stream runs on (the next
        backward segment) while they are in flight."""
        to, frm = _peers(self._rank, tuple(pairs))
        fmt = torch.contiguous_format
        recv = (torch.empty_like(x, memory_format=fmt) if frm is not None
                else torch.zeros_like(x, memory_format=fmt))
        send = x.contiguous()
        ops = [dist.P2POp(dist.isend, send, self._global[d], self.group) for d in to]
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self._global[frm], self.group))
        return InFlight(recv, dist.batch_isend_irecv(ops) if ops else (), send)

    def where(self, mask, a, b, out=None):
        """``a`` where the host-known ``mask`` holds, else ``b``: picks a
        buffer and launches nothing (``out`` is never written)."""
        return a if mask else b

    # value-dimension helpers (rank-local buffers carry no rank axis)
    def split_half(self, x):
        n = x.shape[0]
        return x[: n // 2], x[n // 2:]

    def concat(self, a, b):
        return torch.cat([a, b], dim=0)

    def vmap_ranks(self, fn: Callable) -> Callable:
        return fn  # the buffer is already the rank's own

    def combine_quantized(self, x, q, scales, block: int):
        """``keep + dequant(q, scales)``, the plain version."""
        return _plain_combine(x, q, scales, block)


class FusedDeviceBackend(DeviceBackend):
    """:class:`DeviceBackend` whose int8 combine is the ``mrd_combine``
    kernel when the payload tiles its 256-element block (a 1-D buffer of
    ``len % 256 == 0`` quantized in 256-blocks); any other payload takes
    the plain combine, as the reference routes it."""

    def combine_quantized(self, x, q, scales, block: int):
        if block != QBLOCK or x.ndim != 1 or x.shape[0] % QBLOCK:
            return super().combine_quantized(x, q, scales, block)
        return mrd_combine(x, q, scales)


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

    def size(self) -> int:
        return self.p

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
        return x[:, : n // 2], x[:, n // 2:]

    def concat(self, a, b):
        return torch.cat([a, b], dim=1)

    def vmap_ranks(self, fn: Callable) -> Callable:
        """Lift a per-rank function to the stacked layout: the port's
        per-rank functions (``transforms.quantize`` & co.) already take the
        rank axis as a leading batch dimension."""
        return fn

    def combine_quantized(self, x, q, scales, block: int):
        """``x + dequant(q, scales)`` on ``[p, len]`` rows.  256-blocks run
        as one call of the ``mrd_combine`` kernel over the flattened ``[p *
        len]`` rows (every row is a whole number of blocks, so the flat
        scales ``[p * len / 256]`` line up); other blocks take the plain
        combine."""
        if block != QBLOCK:
            return _plain_combine(x, q, scales, block)
        out = mrd_combine(x.reshape(-1), q.reshape(-1), scales.reshape(-1))
        return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

EXECUTORS: dict[str, Callable[..., Any]] = {}


def register_executor(name: str):
    def deco(factory):
        EXECUTORS[name] = factory
        return factory

    return deco


def make_backend(executor: str, *, axis: Optional[str] = None, p: Optional[int] = None,
                 mesh=None):
    """Instantiate a registered executor, bound to a named dimension of a
    device mesh or to a sim rank count."""
    try:
        factory = EXECUTORS[executor]
    except KeyError:
        raise ValueError(
            f"unknown executor {executor!r}; registered: {sorted(EXECUTORS)}"
        ) from None
    return factory(axis=axis, p=p, mesh=mesh)


def _device_args(name: str, axis, mesh) -> None:
    if axis is None or mesh is None:
        raise ValueError(f"executor {name!r} needs an axis name and a mesh")


@register_executor("device")
def _device(axis=None, p=None, mesh=None):
    _device_args("device", axis, mesh)
    return DeviceBackend(axis, mesh)


@register_executor("device_fused")
def _device_fused(axis=None, p=None, mesh=None):
    _device_args("device_fused", axis, mesh)
    return FusedDeviceBackend(axis, mesh)


@register_executor("sim")
def _sim(axis=None, p=None, mesh=None):
    if p is None:
        raise ValueError("executor 'sim' needs p")
    return SimBackend(p)
