"""Plain PyTorch version of the paged decode-attention kernel.

Written the way the reference's ``flash_attention/ref.py`` oracle is:
gather the blocks into contiguous views, then a masked fp32 softmax.  The
CPU path and the tests use it, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """q: [S, H, hd]; k_pages/v_pages: [N, bs, KV, hd]; block_tables:
    [S, nb] int; lengths: [S] int (valid positions) -> [S, H, hd] in q's
    type."""
    S, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    rep = H // KV
    tables = block_tables.long()
    k = k_pages[tables]  # [S, nb, bs, KV, hd]
    v = v_pages[tables]
    W = k.shape[1] * bs
    k = k.reshape(S, W, KV, hd).float()
    v = v.reshape(S, W, KV, hd).float()
    qg = (q.float() * hd**-0.5).reshape(S, KV, rep, hd)
    s = torch.einsum("sgrh,skgh->sgrk", qg, k)
    mask = torch.arange(W, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("sgrk,skgh->sgrh", p, v)
    return out.reshape(S, H, hd).to(q.dtype)
