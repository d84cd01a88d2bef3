"""Public wrapper of the rmsnorm kernel.

A CPU tensor goes to the plain version (``ref.rmsnorm_ref``); a CUDA
tensor goes to the hand-written CUDA kernel (``csrc/rmsnorm.cu``, built at
first use and loaded with ``ctypes``), or the wrapper raises.  There is no
fallback from the kernel to the plain version on the card.  The kernel has
no backward: a CUDA input that autograd would differentiate is refused
(``models.layers.rmsnorm`` sends those to the plain version itself).

``rmsnorm.launches`` counts kernel launches (a plain integer the caller
may reset), so a run can show that its forward went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import needs_grad
from repro_torch.kernels.build import load_library
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one block of 128 threads a row, each holding up to 16 vectors of 16 bytes
MAX_ROW_BYTES = 128 * 16 * 16


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's shared library."""
    lib = load_library(SOURCE, "rmsnorm")
    fn = lib.repro_rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(x, w) -> None:
    """Raise unless the kernel takes these tensors (any device: the shape,
    type and layout rules; the wrapper adds the device rule)."""
    if x.ndim != 2 or w.ndim != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm takes x [T, d] and w [d], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype not in SUPPORTED_DTYPES or w.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x and w, got "
                        f"{x.dtype}/{w.dtype}")
    T, d = x.shape
    if T == 0 or d % 8 or d * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"rmsnorm kernel needs T > 0, d % 8 == 0 and rows of at most "
                         f"{MAX_ROW_BYTES} bytes, got [{T}, {d}] {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")


def rmsnorm(x, w, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` row by row: x [T, d] f32 or
    bf16, w [d] f32 or bf16 -> [T, d] in x's type; statistics in fp32."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    check_inputs(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, got "
                         f"{x.device}, {w.device}")
    if needs_grad(x, w):
        raise ValueError("rmsnorm kernel has no backward: inputs that require grad take "
                         "the plain version (models.layers.rmsnorm picks it)")
    if x.data_ptr() % 16:
        raise ValueError("rmsnorm: x must be 16-byte aligned")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library().repro_rmsnorm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            SUPPORTED_DTYPES[x.dtype], SUPPORTED_DTYPES[w.dtype], eps, stream,
        )
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc}) for x "
                           f"{tuple(x.shape)} {x.dtype}, w {w.dtype}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
