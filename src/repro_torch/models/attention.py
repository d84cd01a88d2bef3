"""Attention: GQA with RoPE (port of ``repro.models.attention``).

Only the ``full`` implementation (materialized scores) is ported: it is
what the reference's decode and admission prefill use.  Masks are built
from absolute positions, so the same function serves prefill
(``q_offset=0``, causal) and decode (one query against a cache with
``k_valid_len`` valid entries per sequence).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, k_valid_len=None):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd].

    ``causal`` masks key positions after the query's (q[0] at position 0).
    ``k_valid_len``: optional
    number of valid cache entries, a scalar or one per sequence ``[B]``
    (the rest are masked).
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = (q * hd**-0.5).reshape(B, Sq, KV, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).float()  # [B,KV,rep,Sq,Skv]
    k_pos = torch.arange(Skv, device=q.device)
    m = torch.ones((B, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        m &= (q_pos[:, None] >= k_pos[None, :])[None]
    if k_valid_len is not None:
        valid = torch.as_tensor(k_valid_len, device=q.device).reshape(-1, 1, 1)
        m &= k_pos[None, None, :] < valid
    s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", p, v)
    return out.reshape(B, Sq, H, hd)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q [B,1,H,hd] against cache [B,S,KV,hd] with
    ``cache_len`` valid entries (scalar or ``[B]``)."""
    return attention(q, k_cache, v_cache, causal=False, k_valid_len=cache_len)


def qkv_project(ap, x, cfg, positions, theta: float):
    """x: [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] with RoPE at ``positions``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ ap["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ ap["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ ap["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if theta > 0:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v
