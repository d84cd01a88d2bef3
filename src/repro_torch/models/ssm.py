"""Mamba-1 blocks of falcon-mamba and Mamba-2 (SSD) blocks of zamba2
(port of ``repro.models.ssm``).

Serving's selective scans go through the selective-scan kernel's fused
form (``kernels.selective_scan.selective_scan_fused``): the whole prompt
in one launch a layer, where the reference runs a chunked associative scan
in plain jnp, and one step a decode tick from the carried state, where the
reference computes ``decay * h + Bx`` eagerly.  On the CPU the wrapper runs
its plain version.  The kernel has no backward, so training (inputs that
autograd differentiates, ``kernels.needs_grad``) takes the reference's
chunked scan instead (:func:`chunk_scan`).  The projections stay matrix
products; the depthwise conv, softplus, the ``D * x`` skip and the
``silu(z)`` gate stay plain torch.

Parameters of one layer (the reference's ``mamba`` dict, ``x @ W``
layout): in_proj [d, 2 di], conv_w [K, di], conv_b [di], x_proj [di, dtr +
2 N], dt_proj [dtr, di], dt_bias [di], A_log [di, N] fp32, D [di] fp32,
out_proj [di, d].

Mamba-2 has no kernel of the reference's: its SSD scan is a ``lax.scan``
of einsums over chunks there, plain torch here (:func:`_ssd_scan`).
Parameters of one layer (the reference's separate projections): in_z [d,
di], in_x [d, di], in_bc [d, 2 N], in_dt [d, nh], conv_w [K, di + 2 N],
conv_b [di + 2 N], A_log, D and dt_bias [nh] fp32, norm_w [di] (the gated
norm's ``(1 + w)``), out_proj [di, d]; nh = di / ssm_headdim heads of
ssm_headdim channels share one decay each.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import needs_grad
from repro_torch.kernels.selective_scan.ops import selective_scan_fused
from repro_torch.models.layers import dense_init, rmsnorm

FP32_LEAVES = ("A_log", "D")  # mamba1: kept in fp32 whatever the param dtype
MAMBA2_FP32_LEAVES = ("A_log", "D", "dt_bias")  # mamba2: the same
# bytes of the intra-chunk [B, chunks, q, q, nh] fp32 terms the SSD scan
# forms at once (chunks are grouped under this; the carry stays sequential)
SSD_GROUP_BYTES = 256 << 20


def causal_conv1d(x, w, b):
    """Depthwise causal conv: x [B, S, C]; w [K, C]; b [C] -> [B, S, C]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):  # K is tiny (4): unrolled shifts, as the reference
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def conv1d_step(x_tok, conv_state, w, b):
    """x_tok [B, C]; conv_state [B, K-1, C] (past inputs) -> (y [B, C], the
    new state)."""
    window = torch.cat([conv_state, x_tok[:, None]], dim=1)  # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:]


def mamba1_init(gen: torch.Generator, lead: tuple, cfg, dtype) -> dict[str, torch.Tensor]:
    """One layer's parameters (stacked on ``lead`` axes) with the
    reference's distributions, drawn from ``gen`` on its device."""
    d, di, st, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dev = gen.device
    A = torch.arange(1, st + 1, dtype=torch.float32, device=dev).expand(lead + (di, st))
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di), dtype),
        "conv_w": dense_init(gen, lead + (cfg.ssm_conv, di), dtype, fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, lead + (di, dtr + 2 * st), dtype, fan_in=di),
        "dt_proj": dense_init(gen, lead + (dtr, di), dtype, fan_in=dtr),
        "dt_bias": torch.full(lead + (di,), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, lead + (di, d), dtype, fan_in=di),
    }


def _ssm_inputs(p, x1, cfg):
    """x1 [B, S, di] post-conv -> the kernel's fused inputs: dt [B, S, di]
    fp32 (after softplus), A [di, N] fp32, Bs and Cs [B, S, N] in x1's
    type, each contiguous (the kernel's layout)."""
    st, dtr = cfg.ssm_state, cfg.dt_rank
    dt_r, Bs, Cs = torch.split(x1 @ p["x_proj"], [dtr, st, st], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    return dt.contiguous(), A, Bs.contiguous(), Cs.contiguous()


def _gate_out(p, y, x1, z, dtype):
    """The ``D * x`` skip, the ``silu(z)`` gate and the output projection."""
    y = y + p["D"] * x1.float()
    return (y.to(dtype) * F.silu(z)) @ p["out_proj"]


def _linear_scan(a, b, h0=None, reverse: bool = False):
    """h_t = a_t * h_{t-1} + b_t along dim 0, time-major (h_{-1} = h0, or
    0): the inclusive scan of the pairs (a_t, b_t) under the reference's
    ``combine``, ``(al, bl), (ar, br) -> (al * ar, bl * ar + br)``, in
    log2(length) Hillis-Steele steps; each step's slices along dim 0 are
    contiguous, so every pass is a vectorized one.  ``reverse``: h_t =
    a_t * h_{t+1} + b_t, from the end.  The inputs are not changed."""
    a, b = a.clone(), b.clone()
    q, s = a.shape[0], 1
    while s < q:
        if reverse:
            b[:-s] += b[s:] * a[:-s]
            a[:-s] = a[:-s] * a[s:]
        else:
            b[s:] += b[:-s] * a[s:]
            a[s:] = a[s:] * a[:-s]
        s *= 2
    return b if h0 is None else b.add_(a * h0)


class _ChunkRecurrence(torch.autograd.Function):
    """:func:`_linear_scan` with a backward of its own: the adjoint runs
    the same scan backwards in time (lam_t = g_t + a_{t+1} lam_{t+1}), so
    only a and the states h are kept, not the scan's log2(q) steps."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _linear_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        nxt = torch.cat([a[1:], torch.zeros_like(a[:1])])  # a_{t+1}
        lam = _linear_scan(nxt, g.contiguous(), reverse=True)
        h_prev = torch.cat([h0[None], h[:-1]])
        return lam * h_prev, lam, a[0] * lam[0]


def chunk_scan(dt, x1, A, Bs, Cs, h0, chunk: int):
    """The reference's ``_chunk_scan``, differentiable: sequential over
    chunks of ``chunk`` steps (the last one ragged, not padded), and within
    a chunk the fp32 decay ``exp(dt A)`` and input ``dt x B`` [q, B, di, N]
    formed and combined (:class:`_ChunkRecurrence`), so only
    O(B * chunk * di * N) of them is live at once.

    dt [B, S, di] fp32 (after softplus); x1 [B, S, di]; A [di, N] fp32;
    Bs, Cs [B, S, N]; h0 [B, di, N] fp32 -> (y [B, S, di] fp32, h_final
    [B, di, N], the state at position S)."""
    S = x1.shape[1]
    ys, h = [], h0.float()
    for c0 in range(0, S, chunk):
        # time-major [q, B, ...] pieces, so the scan's shifts along time are
        # contiguous slices
        dt_i, x_i, b_i, c_i = (t[:, c0:c0 + chunk].float().transpose(0, 1).contiguous()
                               for t in (dt, x1, Bs, Cs))
        a = torch.exp(dt_i[..., None] * A)
        b = (dt_i * x_i)[..., None] * b_i[:, :, None, :]
        h_all = _ChunkRecurrence.apply(a, b, h)  # [q, B, di, N]
        ys.append(torch.einsum("qbds,qbs->bqd", h_all, c_i))
        h = h_all[-1]
    return torch.cat(ys, dim=1), h


def mamba1_apply(p, x, cfg):
    """Full-sequence mamba1 block: x [B, S, d] -> (out [B, S, d], the state
    a prefill leaves: ``h`` [B, di, N] fp32 and ``conv`` [B, K-1, di], the
    last K-1 pre-conv inputs, zeros in front of a shorter prompt).  The
    scan kernel's fused form, or, for inputs autograd differentiates, the
    chunked scan in chunks of min(cfg.ssm_chunk, S), as the reference's
    stack passes it."""
    K, S = cfg.ssm_conv, x.shape[1]
    x1, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    conv = F.pad(x1, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]
    x1 = F.silu(causal_conv1d(x1, p["conv_w"], p["conv_b"]))
    dt, A, Bs, Cs = _ssm_inputs(p, x1, cfg)
    if needs_grad(dt, x1, A, Bs, Cs):
        h0 = x1.new_zeros((x1.shape[0], cfg.d_inner, cfg.ssm_state), dtype=torch.float32)
        y, h = chunk_scan(dt, x1, A, Bs, Cs, h0, min(cfg.ssm_chunk, S))
    else:
        y, h = selective_scan_fused(dt, x1, A, Bs, Cs)
    return _gate_out(p, y, x1, z, x.dtype), {"h": h, "conv": conv.contiguous()}


def mamba1_init_state(cfg, batch: int, dtype, device) -> dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    }


def mamba1_decode(p, x_tok, state, cfg, write_ok=None):
    """One decode step: x_tok [B, d] -> y [B, d].  The state's tensors are
    updated in place (the scan kernel writes ``h`` over itself), except in
    the rows where ``write_ok`` [B] bool is False."""
    x1, z = (x_tok @ p["in_proj"]).chunk(2, dim=-1)
    x1, conv = conv1d_step(x1, state["conv"], p["conv_w"], p["conv_b"])
    # [B, 1, di]; on the card the einsum may leave x1 transposed
    x1 = F.silu(x1)[:, None].contiguous()
    dt, A, Bs, Cs = _ssm_inputs(p, x1, cfg)
    y, _ = selective_scan_fused(dt, x1, A, Bs, Cs, h0=state["h"], h_final=state["h"],
                                write_ok=write_ok)
    if write_ok is None:
        state["conv"].copy_(conv)
    else:
        torch.where(write_ok[:, None, None], conv, state["conv"], out=state["conv"])
    return _gate_out(p, y[:, 0], x1[:, 0], z, x_tok.dtype)



# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, lead: tuple, cfg, dtype) -> dict[str, torch.Tensor]:
    """One layer's parameters (stacked on ``lead`` axes) with the
    reference's distributions, drawn from ``gen`` on its device; A_log, D
    and dt_bias fp32 constants as the reference initialises them."""
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * st
    dev = gen.device
    return {
        "in_z": dense_init(gen, lead + (d, di), dtype),
        "in_x": dense_init(gen, lead + (d, di), dtype),
        "in_bc": dense_init(gen, lead + (d, 2 * st), dtype),
        "in_dt": dense_init(gen, lead + (d, nh), dtype),
        "conv_w": dense_init(gen, lead + (cfg.ssm_conv, conv_dim), dtype, fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "D": torch.ones(lead + (nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "norm_w": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, lead + (di, d), dtype, fan_in=di),
    }


def _mamba2_split(p, x):
    """x [..., d] -> (z [..., di], xbc [..., di + 2 N], dt [..., nh]), before
    the conv and the softplus."""
    z = x @ p["in_z"]
    xbc = torch.cat([x @ p["in_x"], x @ p["in_bc"]], dim=-1)
    return z, xbc, x @ p["in_dt"]


def _ssd_scan(xh, Bs, Cs, dt, A, h0, chunk: int):
    """SSD chunked scan: sequential over chunks (the carried state),
    matmul form within a chunk, fp32 throughout.

    xh [B, S, nh, hp]; Bs, Cs [B, S, N]; dt [B, S, nh] (after softplus,
    fp32); A [nh] (negative); h0 [B, nh, hp, N] fp32 -> (y [B, S, nh, hp]
    fp32, h_final [B, nh, hp, N]).  The sequence is padded to whole chunks
    after the softplus (dt = 0: decay 1 and no input), so a padded step
    leaves the state as it was and h_final is the state at position S.
    The intra-chunk terms of several chunks are formed at once (at most
    SSD_GROUP_BYTES of them), each chunk's math the reference's; the scores
    above the diagonal are masked to -inf before the exponential, so no
    inf reaches a product."""
    B, S, nh, hp = xh.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh, Bs, Cs, dt = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (xh, Bs, Cs, dt))

    def chunks(t):
        return t.reshape(B, nc, chunk, *t.shape[2:])

    xc, bc, cc, dtc = chunks(xh), chunks(Bs), chunks(Cs), chunks(dt)
    above = ~torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device).tril()
    group = max(1, SSD_GROUP_BYTES // (B * chunk * chunk * nh * 4))
    h = h0.float()
    ys = []
    for c0 in range(0, nc, group):
        sl = slice(c0, min(nc, c0 + group))
        dt_i = dtc[:, sl].float()  # [B, g, q, nh]
        x_i = dt_i[..., None] * xc[:, sl].float()  # [B, g, q, nh, hp]
        b_i, c_i = bc[:, sl].float(), cc[:, sl].float()  # [B, g, q, N]
        cum = torch.cumsum(dt_i * A, dim=2)  # [B, g, q, nh], decreasing
        # intra-chunk: (C B^T) * L [B, g, q, k, nh], then with x
        seg = (cum[:, :, :, None] - cum[:, :, None]).masked_fill_(above[:, :, None], -torch.inf)
        m = torch.einsum("bgqs,bgks->bgqk", c_i, b_i)[..., None] * seg.exp_()
        y = torch.einsum("bgqkh,bgkhp->bgqhp", m, x_i)
        del seg, m
        # each chunk's state from zero, then the carry across the group
        s_i = torch.einsum("bgqhp,bgqs->bghps", x_i * (cum[:, :, -1:] - cum).exp()[..., None], b_i)
        decay = cum[:, :, -1].exp()  # [B, g, nh]
        h_in = []
        for j in range(s_i.shape[1]):
            h_in.append(h)
            h = decay[:, j, :, None, None] * h + s_i[:, j]
        # inter-chunk: the carried state seen through C, decayed to each step
        y += torch.einsum("bgqs,bghps->bgqhp", c_i, torch.stack(h_in, 1)) * cum.exp()[..., None]
        ys.append(y)
    y = torch.cat(ys, 1).reshape(B, nc * chunk, nh, hp)
    return y[:, :S], h


def mamba2_apply(p, x, cfg):
    """Full-sequence mamba2 block: x [B, S, d] -> (out [B, S, d], the state
    a prefill leaves: ``h`` [B, nh, hp, N] fp32 and ``conv`` [B, K-1, di +
    2 N], the last K-1 pre-conv rows, zeros in front of a shorter prompt).
    The SSD scan runs in chunks of min(cfg.ssm_chunk, S), as the
    reference's stack passes it."""
    B, S, _ = x.shape
    di, st, nh, hp, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    z, xbc, dt = _mamba2_split(p, x)
    conv = F.pad(xbc, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]
    xbc = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    x1, Bs, Cs = torch.split(xbc, [di, st, st], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = x1.reshape(B, S, nh, hp)
    h0 = torch.zeros((B, nh, hp, st), dtype=torch.float32, device=x.device)
    y, h = _ssd_scan(xh, Bs, Cs, dt, -torch.exp(p["A_log"]), h0, min(cfg.ssm_chunk, S))
    y = (y + p["D"][:, None] * xh.float()).reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], {"h": h, "conv": conv.contiguous()}


def mamba2_init_state(cfg, batch: int, dtype, device) -> dict[str, torch.Tensor]:
    nh, hp, st = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "h": torch.zeros((batch, nh, hp, st), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * st), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p, x_tok, state, cfg, write_ok=None):
    """One decode step: x_tok [B, d] -> y [B, d].  The state's tensors are
    updated in place, except in the rows where ``write_ok`` [B] bool is
    False."""
    B = x_tok.shape[0]
    di, st, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xbc, dt = _mamba2_split(p, x_tok)
    xbc, conv = conv1d_step(xbc, state["conv"], p["conv_w"], p["conv_b"])
    x1, Bs, Cs = torch.split(F.silu(xbc), [di, st, st], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, nh]
    xh = x1.reshape(B, nh, hp).float()
    decay = torch.exp(dt * -torch.exp(p["A_log"]))
    h = (decay[:, :, None, None] * state["h"]
         + (xh * dt[:, :, None])[..., None] * Bs.float()[:, None, None, :])
    y = torch.einsum("bhps,bs->bhp", h, Cs.float()) + p["D"][:, None] * xh
    y = rmsnorm(y.reshape(B, di).to(x_tok.dtype) * F.silu(z), p["norm_w"], cfg.norm_eps)
    if write_ok is None:
        state["h"].copy_(h)
        state["conv"].copy_(conv)
    else:
        torch.where(write_ok[:, None, None, None], h, state["h"], out=state["h"])
        torch.where(write_ok[:, None, None], conv, state["conv"], out=state["conv"])
    return y @ p["out_proj"]
