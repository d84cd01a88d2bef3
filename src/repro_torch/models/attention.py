"""Attention: GQA with RoPE, causal or bidirectional, with sliding-window
masks (port of ``repro.models.attention``).  Three implementations:

- ``full``: materialized fp32 scores; decode (one query against a cache
  with ``k_valid_len`` valid entries) and short sequences.
- ``flash_scan``: plain-torch online softmax over q and kv chunks,
  O(Sq * chunk) memory and differentiable; long sequences on the CPU and
  under autograd.
- ``kernel`` (the reference's ``pallas``): the flash-attention CUDA kernel
  (``repro_torch.kernels.flash_attention``), forward only.

``impl="auto"`` takes the kernel for CUDA tensors that autograd does not
differentiate, else the reference's rule: ``full`` up to 2048 keys,
``flash_scan`` beyond.  Masks are positional (query ``i`` at ``q_offset +
i``, key ``j`` at ``j``), so one function serves prefill and decode.

Under tensor parallelism (``distributed.sharding``) a rank attends with
its own query heads when ``n_heads`` shards over ``"model"``, and with the
K/V heads they read (repeated ``kv_repeat_factor`` times first when the K/V
heads are fewer than the ranks); the kernels get those plain local
tensors.  When ``n_heads`` does not shard, every rank keeps every head
(its caches replicated over ``"model"``) and runs the whole attention,
where the reference shards the decode caches over sequence; a
sequence-sharded cache merged across ranks by log-sum-exp is a later
item (ROADMAP 6.3).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import needs_grad
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ATTN_IMPLS
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def _mask(q_pos, k_pos, *, causal: bool, window):
    """[Sq, Skv] visibility from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def resolve_impl(impl: str, q, k, v, k_valid_len=None) -> str:
    """The implementation ``attention`` runs for ``impl`` on these inputs."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose one of {ATTN_IMPLS}")
    if impl != "auto":
        return impl
    if q.device.type == "cuda" and k_valid_len is None and not needs_grad(q, k, v):
        return "kernel"
    return "full" if k.shape[1] <= 2048 else "flash_scan"


def attention(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
              impl: str = "auto", chunk: int = 1024, k_valid_len=None):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd].

    ``q_offset``: absolute position of q[0].  ``window``: a key is visible
    while ``q_pos - k_pos < window``.  ``k_valid_len``: number of valid
    cache entries, a scalar or one per sequence ``[B]`` (the rest are
    masked; the kernel does not take it).
    """
    impl = resolve_impl(impl, q, k, v, k_valid_len)
    if impl == "kernel":
        if k_valid_len is not None:
            raise ValueError("the flash-attention kernel takes no k_valid_len")
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = (q * hd**-0.5).reshape(B, Sq, KV, H // KV, hd)
    if impl == "flash_scan":
        return _flash_scan(qg, k, v, causal=causal, window=window, q_offset=q_offset,
                           chunk=chunk, k_valid_len=k_valid_len).reshape(B, Sq, H, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).float()  # [B,KV,rep,Sq,Skv]
    k_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_offset + torch.arange(Sq, device=q.device), k_pos, causal=causal,
              window=window)[None]
    if k_valid_len is not None:
        valid = torch.as_tensor(k_valid_len, device=q.device).reshape(-1, 1, 1)
        m = m & (k_pos[None, None, :] < valid)
    s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", p, v)
    return out.reshape(B, Sq, H, hd)


def _flash_scan(qg, k, v, *, causal, window, q_offset, chunk, k_valid_len):
    """Online softmax over q chunks (outer) and kv chunks (inner), as the
    reference's ``flash_scan``: the transient score block is [B, H,
    q_chunk, chunk] whatever the lengths.  qg: [B,Sq,KV,rep,hd] (scaled)
    -> [B,Sq,KV,rep,hd].

    A kv chunk with no key visible to any query of the q chunk (above the
    causal diagonal, or left of every window) is skipped: the reference's
    walk over it leaves a row's state unchanged, or (for a row with no
    visible key yet) leaves state that the row's first visible key scales
    by exp(-1e30 - m) = 0.  So the result is the reference's whenever each
    row sees a key (its diagonal, in a causal prefill), and a local layer
    costs O(S * window).
    """
    B, Sq, KV, rep, hd = qg.shape
    Skv = k.shape[1]
    dev = qg.device
    q_chunk = min(chunk, Sq) if Sq > 1 else 1
    valid = None if k_valid_len is None else torch.as_tensor(k_valid_len, device=dev)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_i = qg[:, q0:q0 + q_chunk]
        n = q_i.shape[1]
        q_pos = q_offset + q0 + torch.arange(n, device=dev)
        q_lo, q_hi = q_offset + q0, q_offset + q0 + n - 1
        m_run = torch.full((B, KV, rep, n), NEG_INF, device=dev)
        l_run = torch.zeros((B, KV, rep, n), device=dev)
        acc = torch.zeros((B, KV, rep, n, hd), device=dev)
        for k0 in range(0, Skv, chunk):
            k_last = min(k0 + chunk, Skv) - 1
            if (causal and k0 > q_hi) or (window is not None and q_lo - k_last >= window):
                continue
            k_pos = torch.arange(k0, k_last + 1, device=dev)
            msk = _mask(q_pos, k_pos, causal=causal, window=window)[None]
            if valid is not None:
                msk = msk & (k_pos[None, None, :] < valid.reshape(-1, 1, 1))
            s = torch.einsum("bqgrh,bkgh->bgrqk", q_i, k[:, k0:k_last + 1]).float()
            s = torch.where(msk[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            pr = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", pr.to(qg.dtype), v[:, k0:k_last + 1]).float()
            m_run = m_new
        outs.append((acc / l_run.clamp(min=1e-30)[..., None]).to(qg.dtype))
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q [B,1,H,hd] against cache [B,S,KV,hd] with
    ``cache_len`` valid entries (scalar or ``[B]``).  Always ``full``, as
    the reference's: the score tensor is [B,H,1,S].  A rolling window
    cache holds exactly the visible rows, so validity is the only mask."""
    return attention(q, k_cache, v_cache, causal=False, impl="full", k_valid_len=cache_len)


def qkv_project(ap, x, cfg, positions, theta: float):
    """x: [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] with RoPE at ``positions``;
    with ``cfg.qkv_bias`` the biases ``bq``/``bk``/``bv`` are added to the
    projections before RoPE, as the reference does.  Under TP (``sharding``)
    the heads are this rank's (:func:`_tp_qkv`)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if shd.tp_axis() is None:
        q, k, v = x @ ap["wq"], x @ ap["wk"], x @ ap["wv"]
        if cfg.qkv_bias:
            q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    else:
        q, k, v = _tp_qkv(ap, x, cfg)
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    if theta > 0:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _tp_qkv(ap, x, cfg):
    """The q/k/v projections of one TP rank (flattened heads).  Each weight
    whose output dim shards is column-parallel (``tp_copy`` of x in front).
    With heads sharded (``attn_heads_sharded``) q is the rank's ``H / tp``
    heads and k/v the heads they read: its own ``KV / tp`` when those
    shard, else every K/V head (gathered), each repeated
    ``kv_repeat_factor`` times (the reference's ``jnp.repeat``), then the
    rank's chunk.  Otherwise every head, gathered where its projection was
    column-parallel, and every rank runs the whole attention."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hl, _, rep = shd.attn_heads(cfg)
    heads = Hl != H
    xf = shd.tp_copy(x)

    def proj(w, b, width):
        local = shd.tp_dim(width)
        y = (xf if local else x) @ ap[w]
        if cfg.qkv_bias:
            y = y + ap[b]
        return y, local

    q, q_local = proj("wq", "bq", H * hd)
    if q_local and not heads:
        q = shd.tp_gather(q, -1)
    out = [q]
    for w, b in (("wk", "bk"), ("wv", "bv")):
        y, local = proj(w, b, KV * hd)
        if local and heads and rep == 1:
            out.append(y)  # the rank's own K/V heads
            continue
        if local:
            y = shd.tp_gather(y, -1)
        if heads:
            y = y.unflatten(-1, (KV, hd)).repeat_interleave(rep, dim=-2)
            y = shd.tp_split(y, -2).flatten(-2)
        out.append(y)
    return tuple(out)


def out_project(o, wo, cfg):
    """The attention output [B, S, heads * hd] through ``wo``: under TP
    row-parallel (the rank's heads, or its chunk of every head) and the sum
    over ``"model"``."""
    if not shd.tp_dim(cfg.n_heads * cfg.head_dim):
        return o @ wo
    if o.shape[-1] == cfg.n_heads * cfg.head_dim:  # every head: this rank's chunk
        o = shd.tp_split(o, -1)
    return shd.tp_reduce(o @ wo)
