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
