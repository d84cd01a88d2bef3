"""Serving step factories (port of ``repro.distributed.serve``).

Without a mesh the factories return plain functions over tensors.  With a
``DeviceMesh`` (a world, one process a rank: ``("data", "model")`` of
``(1, tp)`` for the continuous pools, ``(dp, tp)`` for the static path)
every step runs under a sharding context (:func:`serving_ctx`): the
model's TP layers run on the rank's heads, channels and vocabulary, the
caches hold the K/V heads the rank's attention reads
(``sharding.attn_heads``: every head where the query heads do not shard,
where the reference's ``cache_specs`` shards the cache's sequence over
``"model"``), and the logits are gathered over ``"model"``, so every rank
takes the same greedy token and the host engines of the ranks make the
same decisions.  The flash, paged-attention and selective-scan kernels
see the rank's plain local tensors.  The weights are the rank's blocks
over ``"model"`` alone (:func:`serve_rules`): the static path's data
ranks are replicas that each serve their shard of the batch; the
reference shards the weights over ``"data"`` too when they are large
(its ``_serve_needs_fsdp``), which the port does not yet (ROADMAP).

- :func:`make_prefill_step`: the whole-prompt forward that returns the
  last position's logits (the reference's ``prefill_32k`` shape cell).
- The static batch path: :func:`make_serve_step` decodes one token of
  every sequence at one cache length, and :func:`make_cached_prefill_step`
  fills a batch's cache from its prompts in one causal forward.
- The contiguous decode pool (``serving.pool.DecodePool``):
  :func:`make_pool_decode_step` advances every slot one token at its own
  length, and :func:`make_slot_prefill_step` admits a prompt into one slot
  of the cache.  Rolling local windows (gemma3), the mamba1 state
  (falcon-mamba) and the hybrid stack's (zamba2) live here.
- The block-paged pool (``serving.paged.PagedDecodePool``), dense, moe
  and vlm caches without a rolling window (mixtral's 4,096-token window
  pages only when ``max_len <= 4096``) and the hybrid stack's shared-block
  caches ``attn_k``/``attn_v``, whose mamba2 state ``m_h``/``m_conv`` stays
  per slot (the steps' ``slot_state``): ``attn="kernel"`` (the reference's
  ``"pallas"``) reads K/V through the block table inside the
  paged-attention CUDA kernel; ``attn="gather"`` gathers each slot's
  blocks into the contiguous layout, runs the contiguous decode step and
  scatters back the one row each slot wrote.  An int8 cache's scale
  planes are paged beside its rows and served by the gather path only.

Admission prefill runs one causal forward over the prompt (the flash
kernel, or one selective scan a mamba1 layer, or one SSD scan in chunks of
``ssm_chunk`` a mamba2 layer, on the card) where the reference scans its
decode step over the padded prompt; the cache rows, the state (up to fp32
rounding: the recurrence and the chunked scan sum in other orders) and
the tokens are the same.  A slot's recurrent state is replaced whole by
the prompt's at admission, so nothing of its previous request survives.  Over an int8 cache the forward
attends over K/V quantized and dequantized, as each of the reference's
prompt positions attends over its dequantized cache, its own row included.
The moe family routes an admission's prompt a token a group, as the
reference's scan does (``transformer.forward_prefill``); the whole-prompt
``make_prefill_step`` routes a sequence a group, as the reference's.

Elastic serving's grow path moves the serving state to joining replicas
through :func:`mrd_broadcast_stacked`: the MRD sum-allreduce of a tree
that only the source rank fills, over the stacked replicas.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import keep

# Cache leaves paged into fixed-size blocks of a shared physical pool
PAGED_LEAVES = ("k", "v", "k_scale", "v_scale", "attn_k", "attn_v")
# cache leaf -> its batch (slot) axis in the transformer.init_cache layout
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "k_scale": 1, "v_scale": 1, "global_k": 1, "global_v": 1,
                    "local_k": 2, "local_v": 2, "h": 1, "conv": 1, "m_h": 2, "m_conv": 2,
                    "attn_k": 1, "attn_v": 1}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def serve_rules(cfg: ModelConfig, mesh) -> shd.ShardingRules:
    """The sharding rules of the port's serving over ``mesh``: TP over
    ``"model"``, no FSDP (the weights are the rank's blocks over
    ``"model"`` alone)."""
    return shd.make_rules(cfg, mesh, fsdp=False)


def serving_ctx(cfg: ModelConfig, mesh):
    """The sharding context every serving step of a world runs under (no
    context without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    return shd.sharding_ctx(cfg, serve_rules(cfg, mesh), mesh)


def _in_ctx(fn, cfg: ModelConfig, mesh):
    """``fn`` run under :func:`serving_ctx`'s context, made once (``fn``
    itself without a mesh)."""
    if mesh is None:
        return fn
    ctx = shd.ShardingContext(cfg, serve_rules(cfg, mesh), mesh)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with shd.use(ctx):
            return fn(*args, **kwargs)

    return run


def param_placer(cfg: ModelConfig, mesh):
    """``place`` for ``transformer.init_params``: the rank's blocks over
    ``"model"`` (None without a mesh: every leaf whole)."""
    if mesh is None:
        return keep
    return shd.Placer(cfg, serve_rules(cfg, mesh), shd.mesh_coords(mesh))


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's blocks of whole ``params`` (the caller's weights, e.g.
    the reference's carried across)."""
    if mesh is None:
        return params
    place = param_placer(cfg, mesh)
    return {k: {n: place(n, v) for n, v in leaf.items()} if isinstance(leaf, dict)
            else place(k, leaf) for k, leaf in params.items()}


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's rows of ``x`` [B / dp, ...] -> [B, ...] (the
    static path's tokens)."""
    ax = shd.ShardingContext(None, None, mesh).axis(shd.DATA)
    return x if ax is None else shd._all_gather(x, 0, ax)


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """``prefill_step(params, batch, stats=None) -> last-position logits [B,
    V]``: the whole-prompt forward over ``batch["tokens"]`` [B, S] (after
    ``batch["patches"]`` [B, P, 1024] where given, with the vision
    frontend; moved to ``device``, where the params live), keeping no
    cache: on the card every attention runs the flash kernel, every mamba1
    scan the selective-scan kernel and every norm the rmsnorm kernel (the
    mamba2 SSD scan is plain torch, as the reference's is plain jnp).  moe
    tokens are routed a sequence a group with capacity drops; ``stats``
    (a dict) collects the assignments routed and dropped."""
    device = resolve_device(device)

    def prefill_step(params, batch, stats=None):
        patches = batch.get("patches")
        return transformer.forward_last_logits(
            params, batch["tokens"].to(device), cfg,
            patches=None if patches is None else patches.to(device), stats=stats)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, tokens [B], cache, cache_len) -> (logits [B, V],
    cache)``: one decode step of every sequence at position ``cache_len``
    (an int, or a tensor of one length a sequence); the cache is written in
    place."""

    def serve_step(params, tokens, cache, cache_len):
        # a Python int is copied to the device here: a loop on the card passes
        # a device tensor instead (a copy from the host waits for the card)
        lengths = torch.as_tensor(cache_len, device=tokens.device).expand(tokens.shape[0])
        return transformer.forward_decode(params, tokens, cache, lengths, cfg)

    return _in_ctx(serve_step, cfg, mesh)


def _fill_cache(cache, rows, slot=None) -> None:
    """Copy a prompt's cache ``rows`` (``transformer.forward_prefill``'s)
    into ``cache``: the positions' rows at the front of each leaf (a
    rolling window's already at p % W) and zeros past them, or the whole
    mamba1 or mamba2 state; into every sequence, or with ``slot`` into that
    slot from ``rows``' one sequence."""
    for n, leaf in cache.items():
        ax = CACHE_BATCH_AXIS[n]
        if slot is None:
            dst, src, seq = leaf, rows[n], ax + 1
        else:  # after select, the sequence axis sits at ax
            dst, src, seq = leaf.select(ax, slot), rows[n].select(ax, 0), ax
        if n in transformer.STATE_LEAVES:  # a state, not rows of positions
            dst.copy_(src)
            continue
        w = src.shape[seq]
        dst.narrow(seq, 0, w).copy_(src)
        dst.narrow(seq, w, dst.shape[seq] - w).zero_()


def make_cached_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, prompt [B, S], cache) -> (last_logits [B, V],
    cache)``: one causal forward over the prompts (on the card the flash
    kernel, every layer) fills positions ``[0, S)`` of the cache, whose
    length may exceed S; the reference scans its decode step over the
    prompt instead, which gives the same cache and logits."""

    def prefill_step(params, prompt, cache):
        last_logits, rows = transformer.forward_prefill(params, prompt, cfg)
        _fill_cache(cache, rows)
        return last_logits, cache

    return _in_ctx(prefill_step, cfg, mesh)


def make_pool_decode_step(cfg: ModelConfig, mesh=None):
    """``pool_step(params, tokens [S], cache, lengths [S], active [S]) ->
    logits [S, V]``: every slot advances at its own length; the cache is
    written in place, and only for active slots.  (The reference decodes
    every slot and keeps the inactive slots' old caches with
    ``select_slots``; here the select is on the one row a slot writes, so
    a tick never copies the cache.)"""

    def pool_step(params, tokens, cache, lengths, active):
        logits, _ = transformer.forward_decode(params, tokens, cache, lengths, cfg,
                                               write_ok=active)
        return logits

    return _in_ctx(pool_step, cfg, mesh)


def make_slot_prefill_step(cfg: ModelConfig, max_prompt_len: int, mesh=None):
    """Offset-prefill into a live cache slot (slot recycling).

    ``slot_prefill(params, prompt [plen], cache, slot) -> last_logits
    [V]``: one causal forward over the prompt; the slot's cache slice gets
    the prompt's K/V rows (a rolling window its last rows, at p % W) and
    zeros past them, and the prompt's whole recurrent state, so nothing of
    the previous request survives.  The other slots are untouched and keep
    decoding across admissions.
    """

    def slot_prefill(params, prompt, cache, slot):
        plen = int(prompt.shape[0])
        if not 0 < plen <= max_prompt_len:
            raise ValueError(f"prompt length {plen} not in (0, {max_prompt_len}]")
        last_logits, rows = transformer.forward_prefill(params, prompt[None], cfg)
        _fill_cache(cache, rows, slot)
        return last_logits[0]

    return _in_ctx(slot_prefill, cfg, mesh)


def split_paged_cache(cache):
    """Split a decode cache dict into (paged leaves, per-slot leaves)."""
    paged = {n: leaf for n, leaf in cache.items() if n in PAGED_LEAVES}
    slot = {n: leaf for n, leaf in cache.items() if n not in PAGED_LEAVES}
    return paged, slot


def validate_pageable(cfg: ModelConfig, max_len: int) -> None:
    """Raise unless this config's decode cache can be block-paged: a dense,
    moe or vlm cache with no rolling window (a modular write index breaks
    the position -> block mapping), or the hybrid stack's shared-block
    caches (its mamba2 state stays per slot).  The reference's rules and
    messages."""
    if cfg.family == "ssm":
        raise ValueError(
            f"family {cfg.family!r} has no pageable KV cache (recurrent state "
            "is O(1) per slot already) — use the contiguous pool"
        )
    if cfg.pattern_local:
        raise ValueError(
            f"{cfg.name}: local-attention layers write their cache "
            "modulo the window; rolling windows are not pageable — "
            "use the contiguous pool"
        )
    if cfg.sliding_window and cfg.sliding_window < max_len:
        raise ValueError(
            f"{cfg.name}: sliding_window={cfg.sliding_window} < "
            f"max_len={max_len} writes the cache modulo the window; "
            "rolling windows are not pageable — use the contiguous pool"
        )


def init_paged_pool(cfg: ModelConfig, max_len: int, num_blocks: int, block_size: int,
                    device="cuda"):
    """Physical block pools ``{"k","v": [L, num_blocks, block_size, KV, hd]}``
    (an int8 cache adds ``k_scale``/``v_scale`` [L, num_blocks, block_size,
    KV]; the hybrid stack's are ``attn_k``/``attn_v`` [G, num_blocks,
    block_size, KV, hd]).

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


def make_paged_pool_decode_step(cfg: ModelConfig, block_size: int, attn: str = "kernel",
                                mesh=None):
    """``pool_step(params, tokens [S], pages, tables [S,nb], lengths [S],
    write_ok [S], slot_state=None) -> logits [S, V]``; ``pages`` and the
    per-slot leaves ``slot_state`` (the hybrid stack's ``m_h``/``m_conv``;
    none for the other families) are updated in place, the state only where
    ``write_ok``.  An int8 cache takes the gather path: the paged-attention
    kernel reads no int8 pages, so ``attn="kernel"`` raises for it."""
    if attn == "kernel":
        if cfg.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "int8 paged decode is served by the gather path (attn='gather')"
            )

        def pool_step_kernel(params, tokens, pages, tables, lengths, write_ok, slot_state=None):
            logits, _, _ = transformer.forward_decode_paged(
                params, tokens, pages, tables, lengths, cfg,
                block_size=block_size, write_ok=write_ok, slot_state=slot_state,
            )
            return logits

        return _in_ctx(pool_step_kernel, cfg, mesh)
    if attn != "gather":
        raise ValueError(f"attn must be 'kernel' or 'gather', got {attn!r}")

    def pool_step_gather(params, tokens, pages, tables, lengths, write_ok, slot_state=None):
        view = {n: gather_block_views(pages[n], tables) for n in pages}
        # the view's rows of an inactive slot go to the trash block below; its
        # recurrent state (in place) is kept by write_ok
        logits, view = transformer.forward_decode(
            params, tokens, {**view, **(slot_state or {})}, lengths, cfg,
            write_ok=write_ok if slot_state else None)
        pb, off = transformer.paged_write_slots(tables, lengths, block_size, write_ok)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        for n in pages:
            pages[n][:, pb, off] = view[n][:, rows, lengths.long()]
        return logits

    return _in_ctx(pool_step_gather, cfg, mesh)


def make_paged_slot_prefill_step(cfg: ModelConfig, max_prompt_len: int, max_len: int,
                                 block_size: int, mesh=None):
    """Offset-prefill a prompt into a slot's block table (paged admission).

    ``slot_prefill(params, prompt [plen], pages, tables, slot, table_row
    [nb], write_mask [nb], slot_state=None) -> last_logits [V]``: one
    causal forward over the prompt, then whole blocks go into the pool:
    logical block ``j`` (zero past the prompt) to ``table_row[j]`` where
    ``write_mask[j]``, else to the trash block, so shared prefix blocks are
    never rewritten.  ``tables[slot]`` becomes ``table_row``, and the slot's
    leaves of ``slot_state`` become the prompt's recurrent state, computed
    from the whole prompt (shared prefix or not), replacing the previous
    request's whole.
    """
    nb = max_len // block_size

    def slot_prefill(params, prompt, pages, tables, slot, table_row, write_mask,
                     slot_state=None):
        plen = int(prompt.shape[0])
        if not 0 < plen <= max_prompt_len:
            raise ValueError(f"prompt length {plen} not in (0, {max_prompt_len}]")
        last_logits, rows = transformer.forward_prefill(params, prompt[None], cfg)
        dst = torch.where(write_mask, table_row, 0).long()
        for n in pages:
            leaf = rows[n][:, 0]  # [L, plen, KV, hd] (scales [L, plen, KV])
            full = leaf.new_zeros((leaf.shape[0], nb * block_size) + leaf.shape[2:])
            full[:, :plen] = leaf
            pages[n][:, dst] = full.reshape(leaf.shape[0], nb, block_size, *leaf.shape[2:])
        for n, leaf in (slot_state or {}).items():
            ax = CACHE_BATCH_AXIS[n]
            leaf.select(ax, slot).copy_(rows[n].select(ax, 0))
        tables[slot] = table_row.to(tables.dtype)
        return last_logits[0]

    return _in_ctx(slot_prefill, cfg, mesh)


# ---------------------------------------------------------------------------
# Elastic serving: the state transfer to joining replicas
# ---------------------------------------------------------------------------

BROADCAST_CHUNK = 1 << 23  # a leaf's elements reduced at once (16 MiB of bf16 a rank)


def _broadcast_tensor(leaf: torch.Tensor, plan, p: int, src: int, dst: int) -> torch.Tensor:
    if leaf.numel() == 0:
        return leaf
    as_bool = leaf.dtype == torch.bool
    out = leaf if leaf.is_contiguous() else torch.empty(leaf.shape, dtype=leaf.dtype,
                                                        device=leaf.device)
    flat = leaf.contiguous().view(-1)
    out_flat = out.view(-1)
    if as_bool:  # bools ride as uint8 (same element size: a view)
        flat, out_flat = flat.view(torch.uint8), out_flat.view(torch.uint8)
    chunk = BROADCAST_CHUNK
    for i in range(0, flat.numel(), chunk):
        piece = flat[i:i + chunk]
        stacked = piece.new_zeros((p,) + piece.shape)
        stacked[src] = piece
        out_flat[i:i + chunk] = plan.run(stacked)[dst]
    return out


def _broadcast_leaf(leaf, plan, p: int, src: int, dst: int):
    if isinstance(leaf, torch.Tensor):
        return _broadcast_tensor(leaf, plan, p, src, dst)
    if isinstance(leaf, np.ndarray):
        writable = leaf.flags.writeable and leaf.flags.c_contiguous
        t = torch.from_numpy(leaf if writable else np.array(leaf, copy=True))
        out = _broadcast_tensor(t, plan, p, src, dst).numpy()
        return leaf if writable else out
    if isinstance(leaf, (bool, int, float)):  # host scalars ride as 0-d arrays
        kind = type(leaf)
        got = _broadcast_leaf(np.array(leaf), plan, p, src, dst)
        return kind(got.item())
    return leaf


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def mrd_broadcast_stacked(tree, p: int, src: int = 0, dst: int = None):
    """The value of ``tree`` (nested dicts, lists and tuples of tensors,
    numpy arrays and host scalars) as replica ``dst`` (default ``p - 1``,
    the newest joiner) receives it from replica ``src`` through the MRD
    sum-allreduce over ``p`` stacked replicas.

    Rank ``src`` contributes each leaf and every other rank zeros, so every
    combine adds a zero and the result is the source's value bit for bit
    (``x + 0`` only turns ``-0.0`` into ``+0.0``; compare with
    ``torch.equal``).  Bool leaves ride as uint8, zero-size leaves pass
    through, a tensor stays on its device (a card's leaves are reduced on
    the card, a host's on the CPU).

    The reference moves the whole tree through one jitted program; here
    the sum plan of ``repro_torch.collectives`` runs one leaf at a time, in
    pieces of ``BROADCAST_CHUNK`` elements, so the stacked ``[p, piece]`` buffers are
    all that is alive beside the tree.  Each contiguous tensor leaf (and
    writable contiguous numpy array) receives ``dst``'s value in its own
    storage, so no copy of the tree is made; a non-contiguous leaf or a
    read-only array comes back as a new one.  A caller that needs the
    source afterwards clones it first."""
    from repro_torch.collectives import plans

    if dst is None:
        dst = p - 1
    if not (0 <= src < p and 0 <= dst < p):
        raise ValueError(f"src={src} and dst={dst} must be ranks of p={p}")
    if p == 1:
        return tree
    plan = plans.allreduce_plan(schedule="mrd", op="sum", executor="sim", p=p)
    return _map_tree(lambda leaf: _broadcast_leaf(leaf, plan, p, src, dst), tree)
