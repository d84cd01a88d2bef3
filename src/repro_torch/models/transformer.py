"""Dense decoder stack for training and serving (port of
``repro.models.transformer``, dense family).

Parameters are a plain dict of tensors with the layers stacked on a
leading ``[L, ...]`` axis and the reference's ``x @ W`` layout::

    embed [V, d], final_norm [d], (lm_head [d, V] unless tied),
    layers: wq [L, d, H*hd], wk/wv [L, d, KV*hd], wo [L, H*hd, d],
            ln1/ln2 [L, d], w1/w3 [L, d, f], w2 [L, f, d]

Interfaces:
  init_params(cfg, generator, device)                         -> params
  forward_train(params, batch, cfg, remat)                    -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)                     -> cache
  forward_prefill(params, tokens, cfg)                        -> (logits, k, v)
  forward_decode(params, tokens, cache, lengths, cfg)         -> (logits, cache)
  forward_decode_paged(params, tokens, pages, tables, lengths, cfg, ...)
                                                              -> (logits, pages)

A Python loop over layers replaces the reference's ``lax.scan``, and an
explicit batch dimension with per-sequence lengths replaces its ``vmap``
over slots.  Cache writes update the given tensors in place (the reference
returns new arrays): a decode tick writes one row per sequence, so copying
the pool would cost more than the tick.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.attention import attention, decode_attention, qkv_project
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_init,
    dtype_of,
    embed_init,
    mlp_apply,
    rmsnorm,
)

LAYER_KEYS = ("wq", "wk", "wv", "wo", "ln1", "ln2", "w1", "w3", "w2")


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict[str, Any]:
    """Random weights with the reference's distributions, drawn from
    ``generator`` on ``device`` (the generator must live on that device)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on {device}")
    dtype = dtype_of(cfg.param_dtype)
    d, f, L, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.head_dim
    params: dict[str, Any] = {
        "embed": embed_init(generator, (cfg.vocab, d), dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, cfg.vocab), dtype)
    zeros = torch.zeros((L, d), dtype=dtype, device=device)
    params["layers"] = {
        "wq": dense_init(generator, (L, d, cfg.n_heads * hd), dtype),
        "wk": dense_init(generator, (L, d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(generator, (L, d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(generator, (L, cfg.n_heads * hd, d), dtype, fan_in=cfg.n_heads * hd),
        "ln1": zeros.clone(),
        "ln2": zeros.clone(),
        "w1": dense_init(generator, (L, d, f), dtype),
        "w3": dense_init(generator, (L, d, f), dtype),
        "w2": dense_init(generator, (L, f, d), dtype, fan_in=f),
    }
    return params


def layer(params, i: int) -> dict[str, torch.Tensor]:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def _logits(params, x, cfg):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _mlp_block(lp, x, cfg):
    return x + mlp_apply(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

REMAT = ("none", "full")


def _decoder_layer(lp, x, cfg, positions):
    """One full-sequence causal layer: x [B, S, d] -> [B, S, d]."""
    B, S = x.shape[:2]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(lp, h, cfg, positions, cfg.rope_theta)
    x = x + attention(q, k, v, causal=True).reshape(B, S, -1) @ lp["wo"]
    return _mlp_block(lp, x, cfg)


def _train_head(params, x, batch, cfg: ModelConfig):
    """Final norm + tied/untied logits + token cross-entropy on the stack
    output ``x``; labels < 0 are masked.  Returns (loss, metrics) with the
    per-sequence mean loss ``per_example`` [B]."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    ll = shifted.gather(-1, labels.clamp(min=0)[..., None])[..., 0] - lse
    ntok = mask.sum().clamp(min=1.0)
    loss = -(ll * mask).sum() / ntok
    per_example = -(ll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    return loss, {"loss": loss, "ntok": ntok, "per_example": per_example}


def forward_train(params, batch, cfg: ModelConfig, remat: str = "none"):
    """Causal LM loss of ``batch`` (``tokens``/``labels`` [B, S]).

    ``remat="full"`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint`` per layer, the reference's
    ``nothing_saveable`` policy on its scan body); ``"none"`` keeps every
    activation.  The stacked layer tensors are unbound once, so their
    gradients are stacked in one pass.  Returns (loss, metrics)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} is not ported; choose one of {REMAT}")
    x = _embed(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    layer_fn = functools.partial(_decoder_layer, cfg=cfg, positions=positions)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in per_layer.items()}
        x = layer_fn(lp, x) if remat == "none" else checkpoint(layer_fn, lp, x,
                                                                use_reentrant=False)
    return _train_head(params, x, batch, cfg)


# ---------------------------------------------------------------------------
# Contiguous cache: prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Contiguous KV cache ``{"k", "v": [L, batch, max_len, KV, hd]}``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype_of(cfg.compute_dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def forward_prefill(params, tokens, cfg: ModelConfig):
    """One causal forward over a prompt.  tokens: [B, S] ->
    (last-position logits [B, V] fp32, k, v [L, B, S, KV, hd])."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(lp, h, cfg, positions, cfg.rope_theta)
        ks.append(k)
        vs.append(v)
        o = attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, -1) @ lp["wo"]
        x = _mlp_block(lp, x, cfg)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), torch.stack(ks), torch.stack(vs)


def forward_decode(params, tokens, cache, lengths, cfg: ModelConfig):
    """One decode step over a contiguous cache with a per-sequence length.

    tokens: [B] int; cache: ``{"k","v": [L, B, W, KV, hd]}``, written in
    place at row ``lengths[b]``; lengths: [B] int (valid entries before
    this token).  Returns (logits [B, V] fp32, cache).
    """
    B = tokens.shape[0]
    rows = torch.arange(B, device=tokens.device)
    lengths = lengths.long()
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = rmsnorm(x[:, None], lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(lp, h, cfg, lengths[:, None], cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[rows, lengths] = k[:, 0]
        vc[rows, lengths] = v[:, 0]
        o = decode_attention(q, kc, vc, lengths + 1)
        x = _mlp_block(lp, x + o.reshape(B, -1) @ lp["wo"], cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Block-paged cache: decode through the paged-attention kernel
# ---------------------------------------------------------------------------


def paged_write_slots(tables, lengths, block_size: int, write_ok=None):
    """Physical (block, offset) of each sequence's next row.

    Sequences with ``write_ok`` False are redirected to the reserved trash
    block 0, so inactive slots never touch a live block.
    """
    lengths = lengths.long()
    pb = tables.long().gather(1, (lengths // block_size)[:, None])[:, 0]
    off = lengths % block_size
    if write_ok is not None:
        pb = torch.where(write_ok, pb, 0)
        off = torch.where(write_ok, off, 0)
    return pb, off


def _paged_attn_layer(lp, x_tok, kp, vp, tables, positions, valid, pb, off, cfg, *,
                      theta: float):
    """One decode layer over block-paged K/V pools.

    x_tok: [S, d]; kp/vp: [N, bs, KV, hd] physical pools of this layer,
    written in place at the precomputed physical (block, offset) ``pb,
    off`` of each sequence's new row; tables: [S, nb] int32; positions:
    [S, 1] absolute position of each token; valid: [S] int32 positions to
    attend over (``lengths + 1``).  The paged-attention kernel reads K/V
    through the block table: no contiguous view is materialized.
    """
    S = x_tok.shape[0]
    h = rmsnorm(x_tok[:, None], lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(lp, h, cfg, positions, theta)
    kp[pb, off] = k[:, 0]
    vp[pb, off] = v[:, 0]
    o = paged_attention(q[:, 0].contiguous(), kp, vp, tables, valid)
    x = x_tok + o.reshape(S, -1) @ lp["wo"]
    return _mlp_block(lp, x, cfg)


def forward_decode_paged(params, tokens, pages, tables, lengths, cfg: ModelConfig, *,
                         block_size: int, write_ok=None):
    """One batched decode step over a block-paged cache.

    tokens: [S] int; pages: ``{"k","v": [L, N, bs, KV, hd]}`` physical
    pools, written in place; tables: [S, nb] int32; lengths: [S] int32;
    write_ok: [S] bool (False redirects the slot's write to the trash
    block 0).  Attention reads K/V through the block table inside the
    paged-attention kernel on the card (its plain version on the CPU); all
    other math matches :func:`forward_decode`.  Returns (logits [S, V]
    fp32, pages).
    """
    pb, off = paged_write_slots(tables, lengths, block_size, write_ok)
    tables = tables.to(torch.int32).contiguous()
    positions = lengths.long()[:, None]
    valid = (lengths + 1).to(torch.int32).contiguous()
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x = _paged_attn_layer(layer(params, i), x, pages["k"][i], pages["v"][i], tables,
                              positions, valid, pb, off, cfg, theta=cfg.rope_theta)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), pages
