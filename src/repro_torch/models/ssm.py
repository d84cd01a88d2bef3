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

Under TP (``distributed.sharding``) a layer runs on the rank's channels
when ``d_inner`` shards over ``"model"`` (mamba2: and its heads do), as
the reference's specs place the leaves: the input projections are
column-parallel (mamba1's ``in_proj`` [d, 2 di] splits at di, so its
output is gathered and each half split again, and each rank holds
matching x and z channels), ``x_proj`` and ``out_proj`` are row-parallel
with the sum over ``"model"``, the replicated conv weights, ``dt_bias``,
mamba2's ``A_log``/``D`` and its norm weight are split to the rank's
channels, and B, C (and mamba1's dt rank input) enter the local scan
through ``tp_copy``.  Each channel's scan is independent, so the
selective-scan kernel runs on the rank's channels.  mamba2's gated norm
reduces over the whole ``d_inner``: its input is gathered, normed (the
rmsnorm kernel on the card) and split again.  A rank's state holds its
channels (mamba2's conv state: its x channels, then B and C whole).
Otherwise every rank runs the whole layer, its column-parallel
projections gathered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import needs_grad
from repro_torch.kernels.selective_scan.ops import selective_scan_fused
from repro_torch.models.layers import dense_init, keep, rmsnorm

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


def mamba1_init(gen: torch.Generator, lead: tuple, cfg, dtype,
                place=keep) -> dict[str, torch.Tensor]:
    """One layer's parameters (stacked on ``lead`` axes) with the
    reference's distributions, drawn from ``gen`` on its device; each kept
    by ``place(name, leaf)`` as soon as it is drawn."""
    d, di, st, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dev = gen.device
    A = torch.arange(1, st + 1, dtype=torch.float32, device=dev).expand(lead + (di, st))
    return {
        "in_proj": place.dense("in_proj", gen, lead + (d, 2 * di), dtype),
        "conv_w": place.dense("conv_w", gen, lead + (cfg.ssm_conv, di), dtype,
                              fan_in=cfg.ssm_conv),
        "conv_b": place("conv_b", torch.zeros(lead + (di,), dtype=dtype, device=dev)),
        "x_proj": place.dense("x_proj", gen, lead + (di, dtr + 2 * st), dtype, fan_in=di),
        "dt_proj": place.dense("dt_proj", gen, lead + (dtr, di), dtype, fan_in=dtr),
        # softplus^-1(0.01)
        "dt_bias": place("dt_bias", torch.full(lead + (di,), -4.6, dtype=dtype, device=dev)),
        "A_log": place("A_log", torch.log(A).contiguous()),
        "D": place("D", torch.ones(lead + (di,), dtype=torch.float32, device=dev)),
        "out_proj": place.dense("out_proj", gen, lead + (di, d), dtype, fan_in=di),
    }


def mamba1_local(cfg) -> bool:
    """Does a mamba1 layer run on this rank's channels (TP with
    ``d_inner`` sharded)?"""
    return shd.tp_dim(cfg.d_inner)


def mamba2_local(cfg) -> bool:
    """Does a mamba2 layer run on this rank's channels and heads?"""
    return shd.tp_dim(cfg.d_inner) and cfg.ssm_nheads % shd.tp_axis().size == 0


def _col(x, w, width: int, local: bool):
    """``x @ w`` for a weight whose ``width`` output columns may shard over
    ``"model"``: the rank's columns when ``local``, else the whole width
    (gathered when the weight is column-parallel)."""
    if not shd.tp_dim(width):
        y = x @ w
        return shd.tp_split(y, -1) if local else y
    y = shd.tp_copy(x) @ w
    return y if local else shd.tp_gather(y, -1)


def _mamba1_in(p, x, cfg):
    """(x1, z) of ``in_proj``: [.., di] each, or the rank's channels."""
    if shd.tp_axis() is None:
        return (x @ p["in_proj"]).chunk(2, dim=-1)
    x1, z = _col(x, p["in_proj"], 2 * cfg.d_inner, False).chunk(2, dim=-1)
    if mamba1_local(cfg):
        x1, z = shd.tp_split(x1, -1), shd.tp_split(z, -1)
    return x1, z


def _channels(w, cfg):
    """A replicated per-channel leaf ([..., di]) cut to this rank's
    channels when the layer runs on them."""
    return shd.tp_split(w, -1) if mamba1_local(cfg) else w


def _ssm_inputs(p, x1, cfg):
    """x1 [B, S, di] post-conv -> the kernel's fused inputs: dt [B, S, di]
    fp32 (after softplus), A [di, N] fp32, Bs and Cs [B, S, N] in x1's
    type, each contiguous (the kernel's layout)."""
    st, dtr = cfg.ssm_state, cfg.dt_rank
    local = shd.tp_axis() is not None and mamba1_local(cfg)
    proj = x1 @ p["x_proj"]
    if local:  # row-parallel x_proj
        proj = shd.tp_reduce(proj)
    dt_r, Bs, Cs = torch.split(proj, [dtr, st, st], dim=-1)
    if local:
        dt_r, Bs, Cs = shd.tp_copy(dt_r), shd.tp_copy(Bs), shd.tp_copy(Cs)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + _channels(p["dt_bias"], cfg).float())
    A = -torch.exp(p["A_log"])
    return dt.contiguous(), A, Bs.contiguous(), Cs.contiguous()


def _gate_out(p, y, x1, z, dtype, cfg=None):
    """The ``D * x`` skip, the ``silu(z)`` gate and the output projection
    (row-parallel under TP on the rank's channels)."""
    y = y + p["D"] * x1.float()
    out = (y.to(dtype) * F.silu(z)) @ p["out_proj"]
    return shd.tp_reduce(out) if cfg is not None and mamba1_local(cfg) else out


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
    x1, z = _mamba1_in(p, x, cfg)
    conv = F.pad(x1, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]
    x1 = F.silu(causal_conv1d(x1, _channels(p["conv_w"], cfg), _channels(p["conv_b"], cfg)))
    dt, A, Bs, Cs = _ssm_inputs(p, x1, cfg)
    if needs_grad(dt, x1, A, Bs, Cs):
        h0 = x1.new_zeros((x1.shape[0], x1.shape[-1], cfg.ssm_state), dtype=torch.float32)
        y, h = chunk_scan(dt, x1, A, Bs, Cs, h0, min(cfg.ssm_chunk, S))
    else:
        y, h = selective_scan_fused(dt, x1, A, Bs, Cs)
    return _gate_out(p, y, x1, z, x.dtype, cfg), {"h": h, "conv": conv.contiguous()}


def mamba1_init_state(cfg, batch: int, dtype, device) -> dict[str, torch.Tensor]:
    """The state of ``batch`` sequences (this rank's channels under TP)."""
    di = cfg.d_inner // (shd.tp_axis().size if mamba1_local(cfg) else 1)
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
    }


def mamba1_decode(p, x_tok, state, cfg, write_ok=None):
    """One decode step: x_tok [B, d] -> y [B, d].  The state's tensors are
    updated in place (the scan kernel writes ``h`` over itself), except in
    the rows where ``write_ok`` [B] bool is False."""
    x1, z = _mamba1_in(p, x_tok, cfg)
    x1, conv = conv1d_step(x1, state["conv"], _channels(p["conv_w"], cfg),
                           _channels(p["conv_b"], cfg))
    # [B, 1, di]; on the card the einsum may leave x1 transposed
    x1 = F.silu(x1)[:, None].contiguous()
    dt, A, Bs, Cs = _ssm_inputs(p, x1, cfg)
    y, _ = selective_scan_fused(dt, x1, A, Bs, Cs, h0=state["h"], h_final=state["h"],
                                write_ok=write_ok)
    if write_ok is None:
        state["conv"].copy_(conv)
    else:
        torch.where(write_ok[:, None, None], conv, state["conv"], out=state["conv"])
    return _gate_out(p, y[:, 0], x1[:, 0], z, x_tok.dtype, cfg)



# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, lead: tuple, cfg, dtype,
                place=keep) -> dict[str, torch.Tensor]:
    """One layer's parameters (stacked on ``lead`` axes) with the
    reference's distributions, drawn from ``gen`` on its device; A_log, D
    and dt_bias fp32 constants as the reference initialises them; each
    kept by ``place(name, leaf)`` as soon as it is drawn."""
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * st
    dev = gen.device
    return {
        "in_z": place.dense("in_z", gen, lead + (d, di), dtype),
        "in_x": place.dense("in_x", gen, lead + (d, di), dtype),
        "in_bc": place.dense("in_bc", gen, lead + (d, 2 * st), dtype),
        "in_dt": place.dense("in_dt", gen, lead + (d, nh), dtype),
        "conv_w": place.dense("conv_w", gen, lead + (cfg.ssm_conv, conv_dim), dtype,
                              fan_in=cfg.ssm_conv),
        "conv_b": place("conv_b", torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev)),
        "A_log": place("A_log", torch.zeros(lead + (nh,), dtype=torch.float32, device=dev)),
        "D": place("D", torch.ones(lead + (nh,), dtype=torch.float32, device=dev)),
        "dt_bias": place("dt_bias", torch.zeros(lead + (nh,), dtype=torch.float32, device=dev)),
        "norm_w": place("norm_w", torch.zeros(lead + (di,), dtype=dtype, device=dev)),
        "out_proj": place.dense("out_proj", gen, lead + (di, d), dtype, fan_in=di),
    }


def _mamba2_split(p, x, cfg=None):
    """x [..., d] -> (z [..., di], xbc [..., di + 2 N], dt [..., nh]), before
    the conv and the softplus (under TP on the rank's channels and heads:
    z, x and dt the rank's, B and C whole)."""
    if cfg is None or shd.tp_axis() is None:
        z = x @ p["in_z"]
        xbc = torch.cat([x @ p["in_x"], x @ p["in_bc"]], dim=-1)
        return z, xbc, x @ p["in_dt"]
    local = mamba2_local(cfg)
    z = _col(x, p["in_z"], cfg.d_inner, local)
    xbc = torch.cat([_col(x, p["in_x"], cfg.d_inner, local), x @ p["in_bc"]], dim=-1)
    dt = x @ p["in_dt"]
    return z, xbc, shd.tp_split(dt, -1) if local else dt


def _mamba2_leaves(p, cfg):
    """(conv_w, conv_b, A_log, D, dt_bias) as this rank's layer uses them:
    under TP on its channels, the conv's x columns and the per-head leaves
    cut to the rank's, the conv's B and C columns whole."""
    names = ("conv_w", "conv_b", "A_log", "D", "dt_bias")
    if shd.tp_axis() is None or not mamba2_local(cfg):
        return tuple(p[n] for n in names)
    di = cfg.d_inner

    def conv(w):
        return torch.cat([shd.tp_split(w[..., :di], -1), w[..., di:]], dim=-1)

    return (conv(p["conv_w"]), conv(p["conv_b"]),
            *(shd.tp_split(p[n], -1) for n in names[2:]))


def _mamba2_norm_out(p, y, z, cfg):
    """The gated norm over the whole ``d_inner`` and the output
    projection; under TP on the rank's channels the norm's input is
    gathered, normed and split again, and ``out_proj`` is row-parallel."""
    if shd.tp_axis() is None or not mamba2_local(cfg):
        y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
        return _col_out(y, p["out_proj"], cfg)
    y = rmsnorm(shd.tp_gather(y * F.silu(z), -1), p["norm_w"], cfg.norm_eps)
    return shd.tp_reduce(shd.tp_split(y, -1) @ p["out_proj"])


def _col_out(y, w, cfg):
    """``y @ w`` for every channel: row-parallel over ``"model"`` when the
    weight's rows shard."""
    if not shd.tp_dim(cfg.d_inner):
        return y @ w
    return shd.tp_reduce(shd.tp_split(y, -1) @ w)


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
    st, hp, K = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_conv
    z, xbc, dt = _mamba2_split(p, x, cfg)
    conv_w, conv_b, A_log, D, dt_bias = _mamba2_leaves(p, cfg)
    di, nh = z.shape[-1], dt.shape[-1]  # the rank's under TP
    conv = F.pad(xbc, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]
    xbc = F.silu(causal_conv1d(xbc, conv_w, conv_b))
    x1, Bs, Cs = torch.split(xbc, [di, st, st], dim=-1)
    if di != cfg.d_inner:  # B and C into the rank's heads
        Bs, Cs = shd.tp_copy(Bs), shd.tp_copy(Cs)
    dt = F.softplus(dt.float() + dt_bias)
    xh = x1.reshape(B, S, nh, hp)
    h0 = torch.zeros((B, nh, hp, st), dtype=torch.float32, device=x.device)
    y, h = _ssd_scan(xh, Bs, Cs, dt, -torch.exp(A_log), h0, min(cfg.ssm_chunk, S))
    y = (y + D[:, None] * xh.float()).reshape(B, S, di).to(x.dtype)
    return _mamba2_norm_out(p, y, z, cfg), {"h": h, "conv": conv.contiguous()}


def mamba2_init_state(cfg, batch: int, dtype, device) -> dict[str, torch.Tensor]:
    """The state of ``batch`` sequences (this rank's heads and channels
    under TP)."""
    n = shd.tp_axis().size if shd.tp_axis() is not None and mamba2_local(cfg) else 1
    nh, hp, st = cfg.ssm_nheads // n, cfg.ssm_headdim, cfg.ssm_state
    return {
        "h": torch.zeros((batch, nh, hp, st), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner // n + 2 * st), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p, x_tok, state, cfg, write_ok=None):
    """One decode step: x_tok [B, d] -> y [B, d].  The state's tensors are
    updated in place, except in the rows where ``write_ok`` [B] bool is
    False."""
    B = x_tok.shape[0]
    st, hp = cfg.ssm_state, cfg.ssm_headdim
    z, xbc, dt = _mamba2_split(p, x_tok, cfg)
    conv_w, conv_b, A_log, D, dt_bias = _mamba2_leaves(p, cfg)
    di, nh = z.shape[-1], dt.shape[-1]  # the rank's under TP
    xbc, conv = conv1d_step(xbc, state["conv"], conv_w, conv_b)
    x1, Bs, Cs = torch.split(F.silu(xbc), [di, st, st], dim=-1)
    dt = F.softplus(dt.float() + dt_bias)  # [B, nh]
    xh = x1.reshape(B, nh, hp).float()
    decay = torch.exp(dt * -torch.exp(A_log))
    h = (decay[:, :, None, None] * state["h"]
         + (xh * dt[:, :, None])[..., None] * Bs.float()[:, None, None, :])
    y = torch.einsum("bhps,bs->bhp", h, Cs.float()) + D[:, None] * xh
    y = y.reshape(B, di).to(x_tok.dtype)
    if write_ok is None:
        state["h"].copy_(h)
        state["conv"].copy_(conv)
    else:
        torch.where(write_ok[:, None, None, None], h, state["h"], out=state["h"])
        torch.where(write_ok[:, None, None], conv, state["conv"], out=state["conv"])
    return _mamba2_norm_out(p, y, z, cfg)
