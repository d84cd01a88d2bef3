"""Public wrappers of the selective-scan kernel (the mamba1 recurrence).

Two input forms of one kernel: :func:`selective_scan` takes the Pallas
kernel's materialized ``decay``/``bx``/``cs``; :func:`selective_scan_fused`
takes the mamba1 block's own ``dt``/``x``/``A``/``Bs``/``Cs`` and forms
``decay`` and ``bx`` inside the kernel (the model's path).  Both return
``(y [B, S, D] fp32, h_final [B, D, N] fp32)`` and take an optional ``h0``;
the fused form can also write ``h_final`` into a given tensor, ``h0``
itself included, and leave the rows of batches where ``write_ok`` is False
as they were (a decode tick updates its slots' states in place).

The kernel has two instances (:func:`scan_instance`, a function of the
form and of S alone): a chunked one for a prompt and for the materialized
form, and a one-step one for a decode tick (the fused form at S = 1).

A CPU tensor goes to the plain versions (``ref``); a CUDA tensor goes to
the hand-written CUDA kernel (``csrc/selective_scan.cu``, built at first
use and loaded with ``ctypes``), or the wrapper raises.  There is no
fallback from the kernel to the plain version on the card.  The kernel has
no backward: CUDA inputs that autograd would differentiate are refused.

``selective_scan.launches`` counts kernel launches of either form and
instance (a plain integer the caller may reset), so a run can show that
its scans went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import needs_grad
from repro_torch.kernels.build import load_library
from repro_torch.kernels.selective_scan.ref import selective_scan_fused_ref, selective_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_STATES = (4, 8, 16)
MAX_BATCH = 65535  # the grid's y dimension


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's shared library."""
    lib = load_library(SOURCE, "selective_scan")
    fn = lib.repro_selective_scan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return lib


def scan_instance(S: int, fused: bool) -> str:
    """The kernel instance a call launches (the one place it is chosen):
    "step" (a thread a channel's 4 states, nothing staged) for the fused
    form at S = 1, a decode tick; "chunked" (a lane 2 states of a channel,
    walking chunks of steps staged through shared memory) otherwise."""
    return "step" if fused and S == 1 else "chunked"


def _check(typed, fp32, B, D, N, h0) -> None:
    """The rules of both forms: types, sizes, layout (any device)."""
    dtype = typed[0].dtype
    if dtype not in SUPPORTED_DTYPES or any(t.dtype != dtype for t in typed):
        raise TypeError(f"selective_scan kernel takes float32 or bfloat16 inputs of one type, "
                        f"got {[t.dtype for t in typed]}")
    if any(t.dtype != torch.float32 for t in fp32):
        raise TypeError(f"selective_scan kernel takes float32 dt, A and h0, got "
                        f"{[t.dtype for t in fp32]}")
    if N not in SUPPORTED_STATES or not 0 < B <= MAX_BATCH or D == 0:
        raise ValueError(f"selective_scan kernel takes N in {SUPPORTED_STATES}, 0 < B <= "
                         f"{MAX_BATCH} and D > 0, got B={B}, D={D}, N={N}")
    if h0 is not None and tuple(h0.shape) != (B, D, N):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)} is not [{B}, {D}, {N}]")
    if not all(t.is_contiguous() for t in (*typed, *fp32)):
        raise ValueError("selective_scan: every input must be contiguous")


def check_inputs(decay, bx, cs, h0=None) -> None:
    """Raise unless the kernel takes these materialized inputs (any device)."""
    if decay.ndim != 4 or bx.shape != decay.shape or cs.ndim != 3 or (
            tuple(cs.shape) != (decay.shape[0], decay.shape[1], decay.shape[3])):
        raise ValueError(f"selective_scan takes decay, bx [B,S,D,N] and cs [B,S,N], got "
                         f"{tuple(decay.shape)}, {tuple(bx.shape)}, {tuple(cs.shape)}")
    B, S, D, N = decay.shape
    if S == 0:
        raise ValueError("selective_scan: the sequence is empty")
    _check((decay, bx, cs), () if h0 is None else (h0,), B, D, N, h0)


def check_fused_inputs(dt, x, A, Bs, Cs, h0=None) -> None:
    """Raise unless the kernel takes these fused inputs (any device)."""
    if dt.ndim != 3 or x.shape != dt.shape or A.ndim != 2 or A.shape[0] != dt.shape[2] or (
            Bs.ndim != 3 or Cs.shape != Bs.shape or Bs.shape[:2] != dt.shape[:2]
            or Bs.shape[2] != A.shape[1]):
        raise ValueError(f"selective_scan_fused takes dt, x [B,S,D], A [D,N] and Bs, Cs "
                         f"[B,S,N], got {tuple(dt.shape)}, {tuple(x.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bs.shape)}, {tuple(Cs.shape)}")
    B, S, D = dt.shape
    if S == 0:
        raise ValueError("selective_scan_fused: the sequence is empty")
    _check((x, Bs, Cs), (dt, A) + (() if h0 is None else (h0,)), B, D, A.shape[1], h0)


def check_state_out(h0, h_final, write_ok, B, D, N) -> None:
    """Raise unless ``h_final`` [B, D, N] fp32 (contiguous, ``h0`` itself or
    apart from it) and ``write_ok`` [B] bool are outputs the kernel takes."""
    if h_final is not None:
        if (tuple(h_final.shape) != (B, D, N) or h_final.dtype != torch.float32
                or not h_final.is_contiguous()):
            raise ValueError(f"selective_scan: h_final must be a contiguous float32 [{B}, {D}, "
                             f"{N}], got {h_final.dtype} {tuple(h_final.shape)}")
        if h0 is not None and h_final.data_ptr() != h0.data_ptr():
            lo, hi = h0.data_ptr(), h0.data_ptr() + h0.nbytes
            if h_final.data_ptr() < hi and lo < h_final.data_ptr() + h_final.nbytes:
                raise ValueError("selective_scan: h_final must be h0 itself or apart from it")
    if write_ok is not None and (tuple(write_ok.shape) != (B,) or write_ok.dtype != torch.bool
                                 or not write_ok.is_contiguous()):
        raise ValueError(f"selective_scan: write_ok must be a contiguous bool [{B}], got "
                         f"{write_ok.dtype} {tuple(write_ok.shape)}")


def _launch(fused: int, tensors, h0, B, S, D, N, h_final=None, write_ok=None):
    dev = tensors[0].device
    extra = tuple(t for t in (h0, h_final, write_ok) if t is not None)
    if any(t.device != dev for t in (*tensors, *extra)):
        raise ValueError(f"selective_scan kernel needs every input on one CUDA device, got "
                         f"{[str(t.device) for t in (*tensors, *extra)]}")
    if needs_grad(*tensors, *extra):
        raise ValueError("selective_scan kernel has no backward: inputs that require grad "
                         "take the plain version")
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    if h_final is None:
        h_final = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    typed = tensors[1] if fused else tensors[0]
    step = int(scan_instance(S, bool(fused)) == "step")
    ptrs = [t.data_ptr() for t in tensors] + [None] * (5 - len(tensors))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = library().repro_selective_scan(
            fused, SUPPORTED_DTYPES[typed.dtype], step, B, S, D, N, *ptrs,
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            None if write_ok is None else write_ok.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed (code {rc}) for B={B} S={S} "
                           f"D={D} N={N} {typed.dtype}, fused={bool(fused)}")
    selective_scan.launches += 1
    return y, h_final


def selective_scan(decay, bx, cs, h0=None):
    """decay, bx [B, S, D, N], cs [B, S, N] (fp32 or bf16), h0 [B, D, N] fp32
    or None -> (y [B, S, D] fp32, h_final [B, D, N] fp32)."""
    if all(t.device.type == "cpu" for t in (decay, bx, cs)) and (
            h0 is None or h0.device.type == "cpu"):
        return selective_scan_ref(decay, bx, cs, h0)
    check_inputs(decay, bx, cs, h0)
    if decay.device.type != "cuda":
        raise ValueError(f"selective_scan kernel needs CUDA tensors, got {decay.device}")
    B, S, D, N = decay.shape
    return _launch(0, (decay, bx, cs), h0, B, S, D, N)


def selective_scan_fused(dt, x, A, Bs, Cs, h0=None, *, h_final=None, write_ok=None):
    """dt [B, S, D] fp32, x [B, S, D], A [D, N] fp32, Bs, Cs [B, S, N] (x, Bs
    and Cs of one type, fp32 or bf16), h0 [B, D, N] fp32 or None -> (y [B,
    S, D] fp32, h_final [B, D, N] fp32), with ``decay = exp(dt * A)`` and
    ``bx = (dt * x) * B`` formed inside the kernel.  ``h_final``: the
    tensor the final state goes to (``h0`` itself updates it in place), a
    new one if None; ``write_ok`` [B] bool: a batch where it is False
    leaves its rows of ``h_final`` as they were."""
    B, D = dt.shape[0], dt.shape[-1]
    if all(t.device.type == "cpu" for t in (dt, x, A, Bs, Cs, h0, h_final, write_ok)
           if t is not None):
        check_state_out(h0, h_final, write_ok, B, D, A.shape[-1])
        return selective_scan_fused_ref(dt, x, A, Bs, Cs, h0, h_final=h_final,
                                        write_ok=write_ok)
    check_fused_inputs(dt, x, A, Bs, Cs, h0)
    check_state_out(h0, h_final, write_ok, B, D, A.shape[1])
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan kernel needs CUDA tensors, got {dt.device}")
    return _launch(1, (dt, x, A, Bs, Cs), h0, B, dt.shape[1], D, A.shape[1], h_final, write_ok)


selective_scan.launches = 0
