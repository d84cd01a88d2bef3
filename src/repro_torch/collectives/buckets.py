"""Bucketizer for the pipelined collective engine (port of
``repro.collectives.buckets``).

Gradient-scale collectives neither ravel the whole parameter tree into
one flat vector nor run a schedule cycle per leaf: leaves are packed into
**dtype-homogeneous, size-capped buckets** with stable pack/unpack
metadata, and the plan layer runs the schedule stage-major across them
(:meth:`repro_torch.collectives.plans.CollectivePlan.run_buffers`).

Layout rules (deterministic for a given tree structure and cap):

- leaves are visited in the reference's ``jax.tree.leaves`` order: a
  tree is nested dicts of tensors, flattened with the keys of every dict
  sorted.  The int8 blocks of a bucket follow its leaf order, so the port
  must visit leaves exactly as the reference does;
- each bucket holds leaves of exactly one dtype (no promotion, ever);
- a bucket closes when adding the next same-dtype leaf would push it past
  ``bucket_bytes`` (a leaf larger than the cap gets a bucket of its own;
  leaves are never split);
- each bucket's length is padded up to a multiple of ``quantum`` (the
  owning plan's ``pad_quantum()``);
- buckets are ordered by their first leaf's tree position.

Stacked trees carry a leading rank axis ``[p, ...]`` on every leaf; pass
``stacked=p`` to :func:`build_layout` and the buffers become ``[p,
length]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

DEFAULT_BUCKET_BYTES = 32 * 2**20

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dtype) -> str:
    return _DTYPE_NAMES[dtype]


def _walk(node, path, leaves: list, paths: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), leaves, paths)
    else:
        leaves.append(node)
        paths.append(path)


def tree_flatten(tree) -> tuple[list, tuple]:
    """(leaves, treedef) of nested dicts, keys sorted at every level as
    ``jax.tree.flatten`` orders a dict; ``treedef`` is the tuple of key
    paths.  The walk is a module function: a nested function that calls
    itself is a reference cycle, which would keep the leaves list (a
    step's gradients) alive until the cyclic collector ran."""
    leaves, paths = [], []
    _walk(tree, (), leaves, paths)
    return leaves, tuple(paths)


def tree_unflatten(treedef: tuple, leaves: Sequence) -> dict:
    out: dict = {}
    for path, leaf in zip(treedef, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside its bucket.  ``shape`` is the per-rank
    shape (no stacked rank axis); ``offset``/``size`` are element counts
    into the bucket's unpadded prefix."""

    index: int  # position in flatten order
    shape: tuple[int, ...]
    dtype: str
    offset: int
    size: int


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One dtype-homogeneous wire buffer and the slots it carries."""

    dtype: str
    slots: tuple[LeafSlot, ...]
    length: int  # padded element length (a multiple of the layout quantum)


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Stable pack/unpack metadata for one tree structure."""

    buckets: tuple[Bucket, ...]
    treedef: Any
    n_leaves: int
    quantum: int
    stacked: Optional[int]  # sim rank count, or None for per-rank trees

    @property
    def bucket_lengths(self) -> tuple[int, ...]:
        return tuple(b.length for b in self.buckets)

    @property
    def total_padded(self) -> int:
        return sum(b.length for b in self.buckets)


def build_layout(tree, *, bucket_bytes: Optional[int] = None, quantum: int = 1,
                 stacked: Optional[int] = None, dtype=None,
                 groups: Optional[Sequence] = None) -> BucketLayout:
    """Plan dtype-homogeneous, size-capped buckets for ``tree`` (only
    shapes and dtypes are read).  ``bucket_bytes=None`` means one
    unbounded bucket per dtype.  ``dtype`` lays the tree out as if every
    leaf had that type (the gradient sync buckets an fp32 view of bf16
    parameters).  ``groups`` (one label a leaf, in flatten order) keeps
    leaves of different labels out of one bucket as dtypes are kept
    apart: under tensor parallelism the leaves replicated over the model
    ranks get buckets of their own, so no int8 block mixes them with a
    rank's own part of a sharded leaf."""
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    leaves, treedef = tree_flatten(tree)
    open_slots: dict[Any, list[LeafSlot]] = {}
    open_elems: dict[Any, int] = {}
    closed: list[tuple[Any, tuple[LeafSlot, ...]]] = []

    def close(dt):
        closed.append((dt, tuple(open_slots.pop(dt))))
        open_elems.pop(dt)

    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        if stacked is not None:
            if not shape or shape[0] != stacked:
                raise ValueError(
                    f"stacked={stacked} needs every leaf to carry a leading rank axis "
                    f"of that size; leaf {i} has shape {shape}"
                )
            shape = shape[1:]
        name = dtype_name(dtype or leaf.dtype)
        dt = name if groups is None else (name, groups[i])
        size = math.prod(shape)
        itemsize = _DTYPES[name].itemsize
        if (dt in open_slots and bucket_bytes is not None and open_slots[dt]
                and (open_elems[dt] + size) * itemsize > bucket_bytes):
            close(dt)
        if dt not in open_slots:
            open_slots[dt], open_elems[dt] = [], 0
        open_slots[dt].append(LeafSlot(index=i, shape=shape, dtype=name,
                                       offset=open_elems[dt], size=size))
        open_elems[dt] += size
    for dt in list(open_slots):
        close(dt)
    closed.sort(key=lambda b: b[1][0].index)  # stable: first-leaf tree order
    buckets = tuple(
        Bucket(dtype=slots[0].dtype, slots=slots,
               length=max(quantum, -(-sum(s.size for s in slots) // quantum) * quantum))
        for dt, slots in closed
    )
    return BucketLayout(buckets=buckets, treedef=treedef, n_leaves=len(leaves),
                        quantum=quantum, stacked=stacked)


def pack_bucket(leaves: Sequence, layout: BucketLayout, i: int, out=None):
    """Pack bucket ``i`` of ``layout`` from a flatten-order leaf list.

    With ``out`` (a zeroed buffer of the bucket's shape), the leaves are
    written into it, each cast to the buffer's type, and no concatenated
    copy is made; the padding keeps its zeros."""
    b = layout.buckets[i]
    p = layout.stacked
    lead = () if p is None else (p,)
    if out is None:
        out = torch.zeros(lead + (b.length,), dtype=_DTYPES[b.dtype],
                          device=leaves[b.slots[0].index].device)
    for s in b.slots:
        leaf = leaves[s.index]
        out[..., s.offset: s.offset + s.size].copy_(leaf.reshape(lead + (s.size,)))
    return out


def pack(tree, layout: BucketLayout, out: Optional[Sequence] = None) -> list:
    """Flatten ``tree`` into the layout's bucket buffers (one ``[length]``
    buffer per bucket, ``[p, length]`` when stacked), or into ``out``."""
    leaves, treedef = tree_flatten(tree)
    if treedef != layout.treedef:
        raise ValueError(f"tree structure {treedef} does not match the layout's {layout.treedef}")
    return [pack_bucket(leaves, layout, i, None if out is None else out[i])
            for i in range(len(layout.buckets))]


def unpack(bufs: Sequence, layout: BucketLayout, dtype=None):
    """Inverse of :func:`pack`: slice each bucket back into leaves of their
    shapes and rebuild the tree.  Every leaf is a fresh tensor (no view
    keeps a bucket alive), in the buffer's type or in ``dtype``."""
    if len(bufs) != len(layout.buckets):
        raise ValueError(f"got {len(bufs)} buffers for a {len(layout.buckets)}-bucket layout")
    lead = () if layout.stacked is None else (layout.stacked,)
    leaves: list = [None] * layout.n_leaves
    for b, buf in zip(layout.buckets, bufs):
        for s in b.slots:
            piece = buf[..., s.offset: s.offset + s.size].reshape(lead + s.shape)
            leaves[s.index] = piece.to(dtype=dtype or piece.dtype, copy=True)
    return tree_unflatten(layout.treedef, leaves)
