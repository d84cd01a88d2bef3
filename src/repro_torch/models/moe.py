"""Mixture-of-Experts MLP: top-k routing with grouped capacity dispatch
(port of ``repro.models.moe``).

Parameters of one layer (the reference's ``moe`` dict): ``router`` [d, E]
in fp32 whatever the param dtype, and the experts' SwiGLU matrices
``w1``/``w3`` [E, d, f] and ``w2`` [E, f, d].

Routing (:func:`routing`): fp32 logits, a softmax, the top_k experts, their
gates renormalised by ``max(sum, 1e-9)``.  The Switch load-balance loss
``E * sum_e f_e P_e`` (:func:`aux_loss`).

Two ways to group tokens, as the reference's paths group them:

- :func:`moe_apply` (the full-sequence forward: ``make_prefill_step``, the
  train forward): a group is a sequence, or a chunk of ``moe_seq_chunk``
  tokens when that divides the length.  Each expert takes at most ``C =
  max(1, int(capacity_factor * Tg * k / E))`` of a group's assignments, in
  token-major order; the rest are dropped (``impl="scatter"``).
  ``impl="dense"`` runs every expert on every token and mixes them by the
  gates (the O(E) oracle).
- :func:`moe_tokens` (serving: admission prefill and decode): every token
  is its own group.  The reference serves by scanning its decode step over
  the prompt, one token a call, so each group is one token; C is then 1
  and the top_k experts are distinct, so nothing is dropped.  The port
  prefills a prompt in one forward, so it routes the prompt's tokens here:
  the assignments sorted by expert, one matrix product per expert that has
  any (one wait on the card a call, for the experts' counts).

The expert products are ``torch.matmul``/``einsum`` (the reference's are
plain ``einsum``s, outside any Pallas kernel).  ``stats``, where given, is
a dict that collects the (token, expert) assignments ``routed`` and
``dropped`` (tensors, summed over calls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import keep

LEAVES = ("router", "w1", "w3", "w2")
FP32_LEAVES = ("router",)  # kept in fp32 whatever the param dtype
IMPLS = ("scatter", "dense")


def moe_init(gen: torch.Generator, lead: tuple, cfg, dtype,
             place=keep) -> dict[str, torch.Tensor]:
    """One layer's parameters (stacked on ``lead`` axes) with the
    reference's distributions, drawn from ``gen`` on its device; each kept
    by ``place(name, leaf)`` as soon as it is drawn."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": place.dense("router", gen, lead + (d, E), torch.float32),
        "w1": place.dense("w1", gen, lead + (E, d, f), dtype, fan_in=d),
        "w3": place.dense("w3", gen, lead + (E, d, f), dtype, fan_in=d),
        "w2": place.dense("w2", gen, lead + (E, f, d), dtype, fan_in=f),
    }


def routing(p, x, cfg):
    """x [..., d] -> (expert idx [..., k], gates [..., k] in x's type,
    probs [..., E] fp32)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return idx, gates.to(x.dtype), probs


def aux_loss(idx, probs, cfg):
    """Switch load-balance loss over every token: E * sum_e (share of the
    assignments routed to e) * (mean router probability of e).  In a world
    with data ranks both shares are the global batch's (``data_sum``)."""
    E = cfg.n_experts
    if shd.data_axis() is None:
        frac_tokens = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
        return E * (frac_tokens * probs.reshape(-1, E).mean(0)).sum()
    n = shd.data_sum(idx.new_tensor(idx.numel()).float())
    counts = shd.data_sum(torch.bincount(idx.reshape(-1), minlength=E).float())
    p = probs.reshape(-1, E)
    mean_p = shd.data_sum(p.sum(0)) / shd.data_sum(p.new_tensor(float(p.shape[0])))
    return E * (counts / n * mean_p).sum()


def capacity(cfg, group_tokens: int) -> int:
    """Assignments an expert takes from a group of ``group_tokens`` tokens."""
    return max(1, int(cfg.capacity_factor * group_tokens * cfg.top_k / cfg.n_experts))


def capacity_keep(idx, cfg):
    """idx [G, Tg, k] -> (flat_e [G, Tg*k], pos_in_e, keep): each
    assignment's expert, its position among that expert's assignments of
    the group in token-major order (a cumsum over the one-hot), and
    whether it is within the expert's capacity."""
    G, Tg, k = idx.shape
    flat_e = idx.reshape(G, Tg * k)
    onehot = F.one_hot(flat_e, cfg.n_experts)
    pos_in_e = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    return flat_e, pos_in_e, pos_in_e < capacity(cfg, Tg)


def _count(stats, name, value) -> None:
    if stats is not None:
        stats[name] = stats.get(name, 0) + value


def _dispatch(p, x, cfg, stats):
    """Grouped capacity dispatch of x [G, Tg, d] (a group a row)."""
    G, Tg, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    idx, gates, _ = routing(p, x, cfg)
    flat_e, pos_in_e, keep = capacity_keep(idx, cfg)
    safe = torch.where(keep, pos_in_e, 0)
    tok = torch.arange(Tg, device=x.device).repeat_interleave(k).expand(G, -1)
    g_ix = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    vals = torch.where(keep[..., None], x[g_ix, tok], 0)
    buf = x.new_zeros((G, E, capacity(cfg, Tg), d))
    buf.index_put_((g_ix, flat_e, safe), vals, accumulate=True)
    ep = _expert_parallel()
    if ep:  # groups over DP -> experts over DP (the reference's expert_buf ->
        # expert_buf_ep constraints): the token all_to_all
        buf = shd.data_all_to_all(buf, 1, 0)
    out = _experts(p, buf, cfg)
    if ep:
        out = shd.data_all_to_all(out, 0, 1)
    gathered = torch.where(keep[..., None], out[g_ix, flat_e, safe], 0)
    y = x.new_zeros((G, Tg, d))
    y.index_put_((g_ix, tok), gathered * gates.reshape(G, Tg * k)[..., None], accumulate=True)
    _count(stats, "routed", keep.numel())
    _count(stats, "dropped", (~keep).sum())
    return y


def _expert_parallel() -> bool:
    """Are the experts sharded over the data ranks of the active world
    (``rules.ep``)?"""
    ctx = shd.active()
    return ctx is not None and ctx.rules.ep and shd.data_axis() is not None


def _experts(p, buf, cfg):
    """Every expert's SwiGLU on its rows of ``buf`` [G, E, C, d]; under TP
    with ``d_ff`` sharded, column- then row-parallel and the sum over
    ``"model"``."""
    tp = shd.tp_dim(cfg.d_ff)
    b = shd.tp_copy(buf) if tp else buf
    h = F.silu(torch.einsum("gecd,edf->gecf", b, p["w1"])) * torch.einsum(
        "gecd,edf->gecf", b, p["w3"])
    out = torch.einsum("gecf,efd->gecd", h, p["w2"])
    return shd.tp_reduce(out) if tp else out


def moe_apply(p, x, cfg, *, impl: str = "scatter", stats=None):
    """x [B, S, d] -> (y [B, S, d], the aux load-balance loss), a group a
    sequence (or a chunk of ``moe_seq_chunk`` tokens when it divides S)."""
    if impl not in IMPLS:
        raise ValueError(f"moe impl {impl!r} not in {IMPLS}")
    B, S, d = x.shape
    idx, gates, probs = routing(p, x, cfg)
    aux = aux_loss(idx, probs, cfg)
    if impl == "dense":
        if _expert_parallel():
            raise NotImplementedError("the dense oracle runs every expert on every token: "
                                      "not with the experts sharded over the data ranks")
        tp = shd.tp_dim(cfg.d_ff)
        xt = shd.tp_copy(x) if tp else x
        h = F.silu(torch.einsum("bsd,edf->bsef", xt, p["w1"])) * torch.einsum(
            "bsd,edf->bsef", xt, p["w3"])
        y_all = torch.einsum("bsef,efd->bsed", h, p["w2"])
        y_all = shd.tp_reduce(y_all) if tp else y_all
        mix = torch.einsum("bske,bsk->bse", F.one_hot(idx, cfg.n_experts).to(x.dtype), gates)
        return torch.einsum("bsed,bse->bsd", y_all, mix), aux
    sub = min(cfg.moe_seq_chunk, S)
    if S % sub:
        sub = S
    if sub < S:  # chunks of the sequence, each a group of every sequence
        xc = x.reshape(B, S // sub, sub, d).transpose(0, 1)
        y = torch.stack([_dispatch(p, xi, cfg, stats) for xi in xc], dim=1)
        return y.reshape(B, S, d), aux
    return _dispatch(p, x, cfg, stats), aux


def moe_tokens(p, x, cfg, stats=None):
    """x [..., d] -> y [..., d] with every token its own group (serving):
    every token reaches its top_k experts, y = sum_j gate_j * expert_j(x)
    accumulated in x's type in the order of j, as the reference's one-token
    dispatch adds them."""
    shape, d, k = x.shape, x.shape[-1], cfg.top_k
    if _expert_parallel():
        raise NotImplementedError("serving's token groups with the experts sharded over data "
                                  "ranks (a static batch over dp > 1 with FSDP weights)")
    tp = shd.tp_dim(cfg.d_ff)
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    idx, gates, _ = routing(p, xf, cfg)
    xin = shd.tp_copy(xf) if tp else xf
    flat = idx.reshape(-1)  # assignment a = t * k + j
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()  # waits for the card
    out = xf.new_empty((T * k, d))
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        sel = order[start:start + n]
        rows = xin[sel // k]
        h = F.silu(rows @ p["w1"][e]) * (rows @ p["w3"][e])
        out[sel] = h @ p["w2"][e]
        start += n
    out = out.reshape(T, k, d)
    y = xf.new_zeros((T, d))
    for j in range(k):
        y += out[:, j] * gates[:, j, None]
    if tp:  # each rank's partial expert outputs, summed over "model"
        y = shd.tp_reduce(y)
    _count(stats, "routed", T * k)
    _count(stats, "dropped", 0)
    return y.reshape(shape)
