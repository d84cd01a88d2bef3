"""Plain PyTorch versions of the selective-scan kernel (port of the
reference's ``kernels/selective_scan/ref.py``).  The CPU path and the
tests use them, and ``chip_smoke.py`` holds the CUDA kernel against them
on the card."""

from __future__ import annotations

import torch


def selective_scan_ref(decay, bx, cs, h0=None):
    """``h_t = decay_t * h_{t-1} + bx_t``; ``y_t = sum_n h_t[., n] * cs_t[n]``.

    decay, bx: [B, S, D, N]; cs: [B, S, N]; h0: [B, D, N] (zeros default).
    A sequential loop over S in fp32.  Returns (y [B, S, D] fp32, h_final
    [B, D, N] fp32)."""
    B, S, D, N = decay.shape
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=decay.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        h = decay[:, t].float() * h + bx[:, t].float()
        ys.append((h * cs[:, t, None, :].float()).sum(-1))
    return torch.stack(ys, dim=1), h


def selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=None, h_final=None, write_ok=None):
    """The scan on the mamba1 block's inputs: dt [B, S, D] fp32 (after
    softplus), x [B, S, D] (the post-conv activations), A [D, N] fp32
    (``-exp(A_log)``), Bs, Cs [B, S, N].  Materializes ``decay = exp(dt *
    A)`` and ``bx = (dt * x) * B`` [B, S, D, N] in fp32, in the order of the
    reference's ``ssm._mamba1_ssm_inputs``, and scans them.  With
    ``h_final`` (which may be ``h0``) the final state is written there,
    except in the batches where ``write_ok`` [B] is False."""
    decay = (dt[..., None] * A).exp_()
    bx = (dt * x.float())[..., None] * Bs.float()[:, :, None, :]
    y, h = selective_scan_ref(decay, bx, Cs.float(), h0)
    if h_final is None:
        return y, h
    if write_ok is not None:
        h = torch.where(write_ok[:, None, None], h, h_final)
    return y, h_final.copy_(h)


STATES_PER_LANE = 2  # the kernel's chunked instance: states a lane keeps


def selective_scan_lanes_ref(decay, bx, cs, h0=None):
    """The kernel's chunked instance in plain torch (tests only): the
    recurrence step by step in fp32, and y summed as the kernel sums it: a
    lane's STATES_PER_LANE adjacent states ``h * c`` first, then a
    channel's N / STATES_PER_LANE lane partials into four interleaved sums
    (lane m into sum m % 4), added as (s0 + s1) + (s2 + s3).  Same
    arguments and results as :func:`selective_scan_ref`."""
    B, S, D, N = decay.shape
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=decay.device) if h0 is None
         else h0.float())
    hs = []
    for t in range(S):
        h = decay[:, t].float() * h + bx[:, t].float()
        hs.append(h)
    prod = torch.stack(hs, 1) * cs.float()[:, :, None, :]  # [B, S, D, N]
    lanes = prod.reshape(B, S, D, N // STATES_PER_LANE, STATES_PER_LANE).sum(-1)
    lanes = torch.nn.functional.pad(lanes, (0, -lanes.shape[-1] % 4))
    sums = lanes.reshape(B, S, D, -1, 4).sum(-2)
    return (sums[..., 0] + sums[..., 1]) + (sums[..., 2] + sums[..., 3]), h
