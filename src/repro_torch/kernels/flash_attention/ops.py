"""Public wrapper of the flash-attention kernel.

A CPU tensor goes to the plain version (``ref.flash_attention_ref``); a
CUDA tensor goes to the hand-written CUDA kernel
(``csrc/flash_attention.cu``, built at first use and loaded with
``ctypes``), or the wrapper raises.  There is no fallback from the kernel
to the plain version on the card.  The kernel has no backward: CUDA
inputs that autograd would differentiate are refused
(``models.attention.attention`` sends those to a plain implementation).

``flash_attention.launches`` counts kernel launches (a plain integer the
caller may reset), so a run can show that its prefill went through the
kernel.

bf16 rows below hd 16 are less than one k16 step of the tensor cores'
``wgmma``: for bf16 hd 8 and 12 (the internvl2-1b and minicpm-2b smoke
configs' heads) the wrapper zero-pads q, k and v to hd 16, keeps the true
scale ``hd**-0.5`` and slices the output back.  Every other instance,
hd 80 among them, runs at its own width.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import needs_grad
from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (8, 12, 16, 64, 80, 128, 256)
BF16_PADDED_HEAD_DIMS = {8: 16, 12: 16}  # bf16 hd -> the width the kernel runs
SUPPORTED_REPS = (1, 2, 4, 5, 7)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's shared library."""
    lib = load_library(SOURCE, "flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def visible_pairs(Sq: int, Skv: int, causal: bool, window=None, q_offset: int = 0) -> int:
    """(query, key) pairs the kernel's mask keeps: ``ref.visible_mask(...).sum()``
    without the [Sq, Skv] mask.  Query i at ``q_offset + i`` sees keys
    [max(0, pos - window + 1), min(Skv - 1, pos)] (no upper clamp to pos
    without ``causal``, no lower one without ``window``).  Each pair costs
    the kernel 4 * hd flops, so this sets its operations bound."""
    pos = q_offset + torch.arange(Sq, dtype=torch.int64)
    hi = pos.clamp(max=Skv - 1) if causal else torch.full_like(pos, Skv - 1)
    lo = (pos - window + 1).clamp(min=0) if window is not None else torch.zeros_like(pos)
    return int((hi - lo + 1).clamp(min=0).sum())


def check_inputs(q, k, v, window) -> None:
    """Raise unless the kernel takes these tensors (any device: the shape,
    type and mask rules; the wrapper adds the device rule)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,Sq,H,hd] and k, v [B,Skv,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hd_k = k.shape
    if Bk != B or hd_k != hd or 0 in (B, Sq, Skv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim, or a length is 0")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if H % KV or H // KV not in SUPPORTED_REPS:
        raise ValueError(f"H/KV = {H}/{KV}: rep must be one of {SUPPORTED_REPS}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0):
    """Attention with positional masks: query i at ``q_offset + i`` sees
    key j when (causal) ``q_pos >= j`` and (window) ``q_pos - j < window``.

    q: [B,Sq,H,hd]; k, v: [B,Skv,KV,hd], H a multiple of KV -> [B,Sq,H,hd]
    in q's type, softmax statistics in fp32.  Non-contiguous views (the
    model's q/k/v after RoPE) are made contiguous here, once.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    check_inputs(q, k, v, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if needs_grad(q, k, v):
        raise ValueError("flash_attention kernel has no backward: inputs that require grad "
                         "take a plain implementation (models.attention.attention picks it)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    width = BF16_PADDED_HEAD_DIMS.get(hd, hd) if q.dtype == torch.bfloat16 else hd
    if width != hd:
        q, k, v = (F.pad(x, (0, width - hd)) for x in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, width, SUPPORTED_DTYPES[q.dtype], int(bool(causal)),
            0 if window is None else int(window), int(q_offset), hd**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc}) for q "
                           f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")
    flash_attention.launches += 1
    return out if width == hd else out[..., :hd].contiguous()


flash_attention.launches = 0
