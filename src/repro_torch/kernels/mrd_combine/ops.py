"""Public wrapper of the ``mrd_combine`` kernel.

A CPU tensor goes to the plain version (``ref.mrd_combine_ref``); a CUDA
tensor goes to the hand-written CUDA kernel (``csrc/mrd_combine.cu``,
built at first use and loaded with ``ctypes``), or the wrapper raises.
There is no fallback from the kernel to the plain version on the card.

``mrd_combine.launches`` counts kernel launches (a plain integer the
caller may reset), so a run can show that its reduce-scatter went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.mrd_combine.ref import QBLOCK, mrd_combine_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mrd_combine.cu"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's shared library."""
    lib = load_library(SOURCE, "mrd_combine")
    fn = lib.repro_mrd_combine
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(x, q, scales) -> None:
    """Raise unless the kernel takes these tensors (any device: the shape,
    type and layout rules; the wrapper adds the device rule)."""
    if x.ndim != 1 or q.shape != x.shape or scales.ndim != 1:
        raise ValueError(
            f"mrd_combine takes x [n], q [n], scales [n/256], got "
            f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scales.shape)}"
        )
    n = x.shape[0]
    if n == 0 or n % QBLOCK or scales.shape[0] != n // QBLOCK:
        raise ValueError(
            f"mrd_combine needs n % {QBLOCK} == 0 and n/{QBLOCK} scales, got n={n}, "
            f"{scales.shape[0]} scales"
        )
    if x.dtype not in SUPPORTED_DTYPES or q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            f"mrd_combine takes float32/bfloat16 x, int8 q and float32 scales, got "
            f"{x.dtype}/{q.dtype}/{scales.dtype}"
        )


def mrd_combine(x, q, scales):
    """``x + dequant(q, scales)`` in ``x``'s type: x [n] f32/bf16, q [n]
    int8, scales [n/256] f32, one scale per 256-element block."""
    check_inputs(x, q, scales)
    tensors = (x, q, scales)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"mrd_combine inputs on mixed devices: {[str(t.device) for t in tensors]}")
    if x.device.type == "cpu":
        return mrd_combine_ref(x, q, scales)
    if x.device.type != "cuda":
        raise ValueError(f"mrd_combine kernel needs CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("q", q), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"mrd_combine: {name} must be contiguous")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("mrd_combine: x and q must be 16-byte aligned")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library().repro_mrd_combine(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
            x.shape[0], SUPPORTED_DTYPES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"mrd_combine kernel launch failed (code {rc}) for x {tuple(x.shape)} {x.dtype}"
        )
    mrd_combine.launches += 1
    return out


mrd_combine.launches = 0
