"""Mamba-1 blocks of falcon-mamba (port of ``repro.models.ssm``, mamba1
only; mamba2 is not ported yet).

Every selective scan goes through the selective-scan kernel's fused form
(``kernels.selective_scan.selective_scan_fused``): the whole prompt in one
launch a layer, where the reference runs a chunked associative scan in
plain jnp, and one step a decode tick from the carried state, where the
reference computes ``decay * h + Bx`` eagerly.  On the CPU the wrapper runs
its plain version.  The projections stay matrix products; the depthwise
conv, softplus, the ``D * x`` skip and the ``silu(z)`` gate stay plain
torch.

Parameters of one layer (the reference's ``mamba`` dict, ``x @ W``
layout): in_proj [d, 2 di], conv_w [K, di], conv_b [di], x_proj [di, dtr +
2 N], dt_proj [dtr, di], dt_bias [di], A_log [di, N] fp32, D [di] fp32,
out_proj [di, d].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan_fused
from repro_torch.models.layers import dense_init

FP32_LEAVES = ("A_log", "D")  # kept in fp32 whatever the param dtype


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


def mamba1_apply(p, x, cfg):
    """Full-sequence mamba1 block: x [B, S, d] -> (out [B, S, d], the state
    a prefill leaves: ``h`` [B, di, N] fp32 and ``conv`` [B, K-1, di], the
    last K-1 pre-conv inputs, zeros in front of a shorter prompt)."""
    K = cfg.ssm_conv
    x1, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    conv = F.pad(x1, (0, 0, max(0, K - 1 - x1.shape[1]), 0))[:, -(K - 1):]
    x1 = F.silu(causal_conv1d(x1, p["conv_w"], p["conv_b"]))
    dt, A, Bs, Cs = _ssm_inputs(p, x1, cfg)
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

