"""Serving step factories for the block-paged decode pool (port of the
paged half of ``repro.distributed.serve``).

Single device: there is no mesh and no sharding rule; the factories return
plain functions over tensors.  Two decode paths:

- ``attn="kernel"`` (the reference's ``"pallas"``):
  :func:`repro_torch.models.transformer.forward_decode_paged` reads K/V
  through the block table inside the paged-attention CUDA kernel, with no
  contiguous view materialized.
- ``attn="gather"``: gather each slot's blocks into exactly the contiguous
  cache layout, run the contiguous decode step, and scatter the one row
  each slot wrote back to its physical (block, offset).

Admission prefill runs one causal forward over the prompt in plain torch
(the reference scans its decode step over the padded prompt; the math is
the same) and writes whole blocks into the pool.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

# Cache leaves paged into fixed-size blocks of a shared physical pool.  The
# reference also pages int8 scale planes and hybrid attention caches; the
# dense family's cache is just K and V.
PAGED_LEAVES = ("k", "v")


def split_paged_cache(cache):
    """Split a decode cache dict into (paged leaves, per-slot leaves)."""
    paged = {n: leaf for n, leaf in cache.items() if n in PAGED_LEAVES}
    slot = {n: leaf for n, leaf in cache.items() if n not in PAGED_LEAVES}
    return paged, slot


def validate_pageable(cfg: ModelConfig, max_len: int) -> None:
    """Raise unless this config's decode cache can be block-paged (the
    ported dense configs have no rolling window, so any ``max_len`` pages)."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} has no ported paged decode path")


def init_paged_pool(cfg: ModelConfig, max_len: int, num_blocks: int, block_size: int,
                    device="cuda"):
    """Physical block pools ``{"k","v": [L, num_blocks, block_size, KV, hd]}``.

    Per-slot block tables map logical block ``j`` (positions ``[j*bs,
    (j+1)*bs)``) to a physical block.  Block 0 is reserved as the trash
    block: writes of inactive slots are redirected there.
    """
    validate_pageable(cfg, max_len)
    tmpl, _ = split_paged_cache(transformer.init_cache(cfg, 1, max_len, resolve_device(device)))
    # a contiguous leaf [L, B, W, *tail] becomes a pool [L, N, bs, *tail]
    return {
        n: leaf.new_zeros((leaf.shape[0], num_blocks, block_size) + leaf.shape[3:])
        for n, leaf in tmpl.items()
    }


def gather_block_views(pool_leaf, tables):
    """``pool_leaf [L, N, bs, *tail]`` + ``tables [S, nb]`` ->
    ``[L, S, nb*bs, *tail]``, the contiguous cache layout (a copy).
    Positions beyond a slot's allocation read the trash block and are
    masked by length."""
    g = pool_leaf[:, tables.long()]  # [L, S, nb, bs, *tail]
    return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3], *g.shape[4:])


def make_paged_pool_decode_step(cfg: ModelConfig, block_size: int, attn: str = "kernel"):
    """``pool_step(params, tokens [S], pages, tables [S,nb], lengths [S],
    write_ok [S]) -> logits [S, V]``; ``pages`` are updated in place."""
    if attn == "kernel":

        def pool_step_kernel(params, tokens, pages, tables, lengths, write_ok):
            logits, _ = transformer.forward_decode_paged(
                params, tokens, pages, tables, lengths, cfg,
                block_size=block_size, write_ok=write_ok,
            )
            return logits

        return pool_step_kernel
    if attn != "gather":
        raise ValueError(f"attn must be 'kernel' or 'gather', got {attn!r}")

    def pool_step_gather(params, tokens, pages, tables, lengths, write_ok):
        view = {n: gather_block_views(pages[n], tables) for n in pages}
        logits, view = transformer.forward_decode(params, tokens, view, lengths, cfg)
        pb, off = transformer.paged_write_slots(tables, lengths, block_size, write_ok)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        for n in pages:
            pages[n][:, pb, off] = view[n][:, rows, lengths.long()]
        return logits

    return pool_step_gather


def make_paged_slot_prefill_step(cfg: ModelConfig, max_prompt_len: int, max_len: int,
                                 block_size: int):
    """Offset-prefill a prompt into a slot's block table (paged admission).

    ``slot_prefill(params, prompt [plen], pages, tables, slot, table_row
    [nb], write_mask [nb]) -> last_logits [V]``: one causal forward over
    the prompt, then whole blocks go into the pool: logical block ``j``
    (zero past the prompt) to ``table_row[j]`` where ``write_mask[j]``,
    else to the trash block, so shared prefix blocks are never rewritten.
    ``tables[slot]`` becomes ``table_row``.
    """
    nb = max_len // block_size

    def slot_prefill(params, prompt, pages, tables, slot, table_row, write_mask):
        plen = int(prompt.shape[0])
        if not 0 < plen <= max_prompt_len:
            raise ValueError(f"prompt length {plen} not in (0, {max_prompt_len}]")
        last_logits, k, v = transformer.forward_prefill(params, prompt[None], cfg)
        dst = torch.where(write_mask, table_row, 0).long()
        for n, rows in (("k", k), ("v", v)):
            leaf = rows[:, 0]  # [L, plen, KV, hd]
            full = leaf.new_zeros((leaf.shape[0], nb * block_size) + leaf.shape[2:])
            full[:, :plen] = leaf
            pages[n][:, dst] = full.reshape(leaf.shape[0], nb, block_size, *leaf.shape[2:])
        tables[slot] = table_row.to(tables.dtype)
        return last_logits[0]

    return slot_prefill
