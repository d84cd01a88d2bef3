"""The block-paged decode pool (port of ``repro.serving.paged``).

The cache is a shared physical pool of fixed-size blocks
(``distributed.serve.init_paged_pool``):

- :class:`BlockAllocator` — host-side free list with refcounts and a
  content-addressed prefix registry.  Identical prompt prefixes map their
  full blocks to the same physical blocks (stored once, refcounted per
  sharer); :meth:`BlockAllocator.fork_private` is the copy-on-write guard
  on any block a request may write.
- :class:`PagedDecodePool` — the device half.  Admission reserves blocks
  for the request's whole budget (``ceil((plen + max_new + 1) / bs)``), so
  decode never faults on a missing block; a per-slot ``slot_cap`` freezes
  a slot's length at the reservation edge.

Block 0 is the trash block: device writes of inactive slots land there.
With ``share_prefixes=False`` every block is private: no registry lookup
or registration, and :meth:`PagedDecodePool.can_admit` counts no hits.
An int8 cache's scale planes are pages beside its rows (``attn="gather"``
only).  The hybrid stack (zamba2) pages its shared block's ``attn_k``/
``attn_v`` and keeps each slot's mamba2 state (``m_h``/``m_conv``,
``transformer.init_state``) beside the pools: admission replaces the
slot's state with the prompt's, a decode tick advances it in place.

Unlike the reference, a block may carry several registry keys (a set per
block): the reference keeps one key per block, so registering a second
key on a block overwrote the first and left it dangling.

Elastic resize: :meth:`BlockAllocator.export_arrays` /
:meth:`BlockAllocator.from_arrays` and :meth:`PagedDecodePool.export_state`
/ :meth:`PagedDecodePool.import_state` put the host's pool state in flat
int32 arrays that the grow's broadcast carries to a joining replica (the
reference's layout; every key of a block rides as its own entry, so the
sets come back whole).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import serve as dserve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


class BlockAllocator:
    """Free-list block allocator with refcounts and a prefix registry.

    Block ids are ``1..num_blocks-1`` (0 is the reserved trash block).
    Invariants (checked by :meth:`check`):

    - a block is on the free list iff its refcount is 0;
    - a block is never handed out twice while allocated;
    - every registered key points at a live block that lists the key, and
      a block's keys are dropped exactly when its last sharer releases it.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 1 usable block + the trash block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() from the end -> lowest ids first (deterministic layouts)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.ref = np.zeros((num_blocks,), np.int64)
        self.ref[0] = 1  # trash block: permanently pinned
        self._block_of: Dict[bytes, int] = {}  # prefix key -> block id
        self._keys_of: Dict[int, Set[bytes]] = {}  # block id -> its keys

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Live blocks excluding the trash block."""
        return self.num_blocks - 1 - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError(f"out of cache blocks ({self.num_blocks - 1} usable)")
        b = self._free.pop()
        self.ref[b] = 1
        return b

    def retain(self, bid: int) -> None:
        if bid == 0 or self.ref[bid] <= 0:
            raise ValueError(f"retain of unallocated block {bid}")
        self.ref[bid] += 1

    def release(self, bid: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        if bid == 0 or self.ref[bid] <= 0:
            raise ValueError(f"release of unallocated block {bid}")
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            for key in self._keys_of.pop(bid, ()):
                del self._block_of[key]
            self._free.append(bid)
            return True
        return False

    # -- prefix sharing ------------------------------------------------------

    def lookup(self, key: bytes) -> Optional[int]:
        """Adopt the block registered under ``key`` (bumps its refcount)."""
        bid = self._block_of.get(key)
        if bid is not None:
            self.ref[bid] += 1
        return bid

    def peek(self, key: bytes) -> Optional[int]:
        """Registry lookup without taking a reference (capacity planning)."""
        return self._block_of.get(key)

    def register(self, key: bytes, bid: int) -> None:
        """Publish ``bid`` (which the caller holds) as the block for ``key``."""
        if bid == 0 or self.ref[bid] <= 0:
            raise ValueError(f"register of unallocated block {bid}")
        if key in self._block_of:
            return  # first registration wins (content is identical anyway)
        self._block_of[key] = bid
        self._keys_of.setdefault(bid, set()).add(key)

    def fork_private(self, bid: int) -> Tuple[int, bool]:
        """Copy-on-write: a block id the caller may safely write.

        The sole owner keeps ``(bid, False)``; a sharer's reference moves to
        a fresh block ``(new_bid, True)`` and every other sharer's view stays
        untouched.  The caller fills the new block.
        """
        if self.ref[bid] == 1:
            return bid, False
        nb = self.alloc()  # before release: MemoryError must not leak the ref
        self.release(bid)
        return nb, True

    # -- elastic resize -----------------------------------------------------

    def export_arrays(self) -> Dict[str, np.ndarray]:
        """The allocator as flat int32 arrays a joining replica adopts: the
        refcounts, the free list in pop order (it decides later layouts, so
        a joiner replays it exactly), and the registry as concatenated key
        bytes, key lengths and key blocks, sorted by key."""
        keys = sorted(self._block_of.items())
        return {
            "ref": self.ref.astype(np.int32),
            "free": np.asarray(self._free, np.int32),
            "key_bytes": np.frombuffer(b"".join(k for k, _ in keys), np.uint8).copy(),
            "key_lens": np.asarray([len(k) for k, _ in keys], np.int32),
            "key_blocks": np.asarray([b for _, b in keys], np.int32),
        }

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], num_blocks: int,
                    block_size: int) -> "BlockAllocator":
        """Rebuild an allocator from :meth:`export_arrays`' output, each
        block's key set whole."""
        a = cls(num_blocks, block_size)
        a.ref = np.asarray(arrays["ref"]).astype(np.int64)
        a._free = [int(b) for b in np.asarray(arrays["free"])]
        packed = np.asarray(arrays["key_bytes"], np.uint8).tobytes()
        off = 0
        for ln, bid in zip(np.asarray(arrays["key_lens"]), np.asarray(arrays["key_blocks"])):
            key = packed[off: off + int(ln)]
            off += int(ln)
            a._block_of[key] = int(bid)
            a._keys_of.setdefault(int(bid), set()).add(key)
        a.check()
        return a

    def check(self) -> None:
        """Raise AssertionError unless the allocator invariants hold."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate block on free list"
        assert 0 not in free, "trash block on free list"
        assert self.ref[0] >= 1, "trash block unpinned"
        for b in range(1, self.num_blocks):
            assert (self.ref[b] == 0) == (b in free), (
                f"block {b}: ref={self.ref[b]} free={b in free}"
            )
        for key, b in self._block_of.items():
            assert key in self._keys_of.get(b, ()), f"registry asymmetry at {b}"
            assert self.ref[b] > 0, f"registered block {b} is free"
        for b, keys in self._keys_of.items():
            for key in keys:
                assert self._block_of.get(key) == b, f"dangling key on block {b}"


class PagedDecodePool:
    """Block-paged continuous-batching pool over one device.

    Device state (:attr:`state`): the page pools, the per-slot recurrent
    state (hybrid stack), the block tables ``[slots, nb]`` and the last
    token of each slot.  Host state (:meth:`export_state`, also under
    ``state["host"]``): the allocator, each slot's block list, and the
    per-slot ``lengths`` and ``slot_cap`` (the host advances them, so
    reading them never waits on the device).
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int, max_prompt_len: int,
                 block_size: int = 8, num_blocks: Optional[int] = None,
                 share_prefixes: bool = True, attn: str = "kernel", device="cuda", mesh=None):
        if max_prompt_len >= max_len:
            raise ValueError("max_prompt_len must leave room to decode")
        if max_len % block_size:
            raise ValueError(f"max_len={max_len} must be a multiple of block_size={block_size}")
        dserve.validate_pageable(cfg, max_len)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots, self.max_len, self.max_prompt_len = slots, max_len, max_prompt_len
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        if num_blocks is None:
            num_blocks = slots * self.blocks_per_slot + 1  # capacity parity + trash
        self.num_blocks = num_blocks
        self.share_prefixes = share_prefixes
        self.attn = attn
        self.mesh = mesh  # a TP world: the pages hold this rank's K/V heads
        self._pool_step = dserve.make_paged_pool_decode_step(cfg, block_size, attn=attn,
                                                             mesh=mesh)
        self._slot_prefill = dserve.make_paged_slot_prefill_step(
            cfg, max_prompt_len, max_len, block_size, mesh=mesh
        )
        self.reset()

    def reset(self):
        self.allocator = BlockAllocator(self.num_blocks, self.block_size)
        self.slot_blocks: List[List[int]] = [[] for _ in range(self.slots)]
        self.prefix_saved_blocks = 0  # running count of share hits
        with dserve.serving_ctx(self.cfg, self.mesh):
            self.pages = dserve.init_paged_pool(
                self.cfg, self.max_len, self.num_blocks, self.block_size, self.device
            )
            self.slot_state = transformer.init_state(self.cfg, self.slots, self.device)
        dev = self.device
        self.tables = torch.zeros((self.slots, self.blocks_per_slot), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        self.lengths = np.zeros((self.slots,), np.int32)
        self.slot_cap = np.zeros((self.slots,), np.int32)

    @property
    def state(self) -> dict:
        """The pool's whole state, the one tree a grow sends a joiner: what
        a decode tick reads on the device (pages, tables, the per-slot
        recurrent state and the last tokens) and, under ``host``, the host's
        side (:meth:`export_state`)."""
        return {"pages": self.pages, "tables": self.tables, "slot": self.slot_state,
                "tokens": self.tokens, "host": self.export_state()}

    @state.setter
    def state(self, value: dict) -> None:
        """Install a :attr:`state` tree: the device leaves, and the host's
        side when the tree carries it (the allocator rebuilt from it)."""
        self.pages, self.tables = value["pages"], value["tables"]
        self.slot_state, self.tokens = value["slot"], value["tokens"]
        if "host" in value:
            self.import_state(value["host"])

    # -- decode --------------------------------------------------------------

    def step(self, params, active: np.ndarray) -> torch.Tensor:
        """Advance every active slot one token; returns the tokens [S] (on
        the device; inactive slots keep their last token)."""
        active_d = torch.from_numpy(active).to(self.device)
        lengths_d = torch.from_numpy(self.lengths).to(self.device)
        logits = self._pool_step(params, self.tokens, self.pages, self.tables,
                                 lengths_d, active_d, self.slot_state)
        self.tokens = torch.where(active_d, torch.argmax(logits, dim=-1), self.tokens)
        # freeze at the slot's reserved capacity: the reservation covers
        # plen + max_new + 1, so useful tokens come strictly before it
        adv = active & (self.lengths < self.slot_cap - 1)
        self.lengths = np.where(adv, self.lengths + 1, self.lengths).astype(np.int32)
        return self.tokens

    def capacity_mask(self) -> np.ndarray:
        """Slots frozen at their reserved capacity."""
        return self.lengths >= self.slot_cap - 1

    # -- host-side block planning -------------------------------------------

    def _blocks_needed(self, plen: int, max_new: int) -> int:
        need = min(self.max_len, plen + max_new + 1)
        return -(-need // self.block_size)

    def _plan_blocks(self, prompt: np.ndarray, plen: int, max_new: int):
        """Map a request onto physical blocks.

        Full prompt blocks are content-addressed by their cumulative prefix
        (``prompt[:(j+1)*bs]``); any block the request may write (``j >=
        plen // bs``) passes the copy-on-write guard.  Rolls back cleanly
        when the pool runs out of blocks.
        """
        bs = self.block_size
        n_need = self._blocks_needed(plen, max_new)
        first_write = plen // bs
        blocks: List[int] = []
        write_mask: List[bool] = []
        shared = 0
        try:
            for j in range(n_need):
                if self.share_prefixes and j < first_write:
                    key = prompt[: (j + 1) * bs].tobytes()
                    bid = self.allocator.lookup(key)
                    if bid is not None:
                        blocks.append(bid)
                        write_mask.append(False)
                        shared += 1
                        continue
                    bid = self.allocator.alloc()
                    self.allocator.register(key, bid)
                else:
                    bid = self.allocator.alloc()
                if j >= first_write:
                    bid, _ = self.allocator.fork_private(bid)
                blocks.append(bid)
                write_mask.append(True)
        except MemoryError:
            for b in blocks:
                self.allocator.release(b)
            raise
        return blocks, write_mask, shared

    def can_admit(self, prompt, max_new: int) -> bool:
        """Would :meth:`admit` succeed right now without evicting anyone?"""
        prompt = np.asarray(prompt, np.int32)
        plen = int(prompt.shape[0])
        n_need = self._blocks_needed(plen, max_new)
        if n_need > self.num_blocks - 1:
            raise ValueError(
                f"request needs {n_need} blocks but the pool only has "
                f"{self.num_blocks - 1}: it can never be admitted"
            )
        bs = self.block_size
        hits = sum(self.allocator.peek(prompt[: (j + 1) * bs].tobytes()) is not None
                   for j in range(plen // bs)) if self.share_prefixes else 0
        return self.allocator.free_blocks >= n_need - hits

    # -- admission / retirement ---------------------------------------------

    def admit(self, params, prompt, slot: int, *, max_new: int) -> int:
        """Reserve blocks for the request's whole budget, prefill the prompt
        through the slot's new block table, return the first token."""
        prompt = np.asarray(prompt, np.int32)
        plen = int(prompt.shape[0])
        if not 0 < plen <= self.max_prompt_len:
            raise ValueError(f"prompt length {plen} not in (0, {self.max_prompt_len}]")
        if self.slot_blocks[slot]:
            self.release_slot(slot)  # defensive: the engine releases at retire
        blocks, write_mask, shared = self._plan_blocks(prompt, plen, int(max_new))
        self.slot_blocks[slot] = blocks
        self.prefix_saved_blocks += shared
        table_row = np.zeros((self.blocks_per_slot,), np.int32)
        table_row[: len(blocks)] = blocks
        mask = np.zeros((self.blocks_per_slot,), bool)
        mask[: len(blocks)] = write_mask
        dev = self.device
        last_logits = self._slot_prefill(
            params, torch.from_numpy(prompt).long().to(dev), self.pages, self.tables,
            slot, torch.from_numpy(table_row).to(dev), torch.from_numpy(mask).to(dev),
            self.slot_state,
        )
        tok0 = torch.argmax(last_logits)
        self.tokens[slot] = tok0
        self.lengths[slot] = plen
        self.slot_cap[slot] = len(blocks) * self.block_size
        return int(tok0)

    def release_slot(self, slot: int) -> None:
        """Return the slot's blocks to the allocator (slot recycling)."""
        for b in self.slot_blocks[slot]:
            self.allocator.release(b)
        self.slot_blocks[slot] = []

    # -- elastic resize -----------------------------------------------------

    def export_state(self) -> Dict[str, np.ndarray]:
        """The host's pool state as flat arrays (a grow broadcasts them
        beside :attr:`state`): the allocator, the per-slot block lists as
        flat ids and lengths, the share count, and the per-slot ``lengths``
        and ``slot_cap`` (which the reference keeps on the device)."""
        return {
            "allocator": self.allocator.export_arrays(),
            "slot_blocks": np.asarray([b for bl in self.slot_blocks for b in bl], np.int32),
            "slot_lens": np.asarray([len(bl) for bl in self.slot_blocks], np.int32),
            "prefix_saved": np.asarray(self.prefix_saved_blocks, np.int32),
            "lengths": self.lengths.copy(),
            "slot_cap": self.slot_cap.copy(),
        }

    def import_state(self, st: Dict[str, np.ndarray]) -> None:
        """Adopt a broadcast :meth:`export_state` tree (the joiner's half of
        a grow; :attr:`state` arrives beside it)."""
        self.allocator = BlockAllocator.from_arrays(st["allocator"], self.num_blocks,
                                                    self.block_size)
        flat = [int(b) for b in np.asarray(st["slot_blocks"])]
        out, off = [], 0
        for ln in np.asarray(st["slot_lens"]):
            out.append(flat[off: off + int(ln)])
            off += int(ln)
        self.slot_blocks = out
        self.prefix_saved_blocks = int(st["prefix_saved"])
        self.lengths = np.asarray(st["lengths"], np.int32).copy()
        self.slot_cap = np.asarray(st["slot_cap"], np.int32).copy()

    @property
    def cache_bytes(self) -> int:
        leaves = (*self.pages.values(), *self.slot_state.values(), self.tables)
        return int(sum(t.numel() * t.element_size() for t in leaves))
