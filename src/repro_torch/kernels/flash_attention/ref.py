"""Plain PyTorch version of the flash-attention kernel (port of the
reference's ``kernels/flash_attention/ref.py``): materialized fp32 scores
under the positional masks, then a softmax.  The CPU path and the tests
use it, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(Sq, Skv, causal, window=None, q_offset=0, device=None):
    """[Sq, Skv] bool: key j is visible to query i (at ``q_offset + i``)."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    k_pos = torch.arange(Skv, device=device)
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd] in q's type;
    fp32 softmax."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = (q.float() * hd**-0.5).reshape(B, Sq, KV, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg, k.float())
    s = torch.where(visible_mask(Sq, Skv, causal, window, q_offset, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
