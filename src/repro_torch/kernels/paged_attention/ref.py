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


def paged_attention_partials(q, k_pages, v_pages, block_tables, lengths, pages_per_split):
    """The kernel's per-split arithmetic in plain torch: the positions of
    split j are pages [j * pages_per_split, (j + 1) * pages_per_split) of
    the table; returns fp32 (m [S, H, splits], l [S, H, splits], acc [S, H,
    splits, hd]) with ``acc`` not yet divided by ``l``.  A split that holds
    no live position is empty: m = -1e30, l = 0, acc = 0."""
    S, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    rep = H // KV
    nb = block_tables.shape[1]
    W = nb * bs
    tables = block_tables.long()
    k = k_pages[tables].reshape(S, W, KV, hd).float()
    v = v_pages[tables].reshape(S, W, KV, hd).float()
    qg = (q.float() * hd**-0.5).reshape(S, KV, rep, hd)
    s = torch.einsum("sgrh,skgh->sgrk", qg, k)
    live = torch.arange(W, device=q.device)[None, :] < lengths.to(q.device).clamp(0, W)[:, None]
    ms, ls, accs = [], [], []
    for lo in range(0, W, pages_per_split * bs):
        hi = min(lo + pages_per_split * bs, W)
        ok = live[:, None, None, lo:hi]
        m = torch.where(ok, s[..., lo:hi], NEG_INF).amax(-1)
        p = torch.where(ok, torch.exp(s[..., lo:hi] - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("sgrk,skgh->sgrh", p, v[:, lo:hi]))
    m, l, acc = torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)
    return m.reshape(S, H, -1), l.reshape(S, H, -1), acc.reshape(S, H, -1, hd)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, pages_per_split):
    """The kernel's split-and-merge in plain torch: the partials of
    :func:`paged_attention_partials` merged by the log-sum-exp rule, as the
    kernel's combine step does (tests only; the CPU path runs
    :func:`paged_attention_ref`)."""
    m, l, acc = paged_attention_partials(q, k_pages, v_pages, block_tables, lengths,
                                         pages_per_split)
    c = torch.exp(m - m.amax(-1, keepdim=True))
    out = (acc * c[..., None]).sum(-2) / (l * c).sum(-1).clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
