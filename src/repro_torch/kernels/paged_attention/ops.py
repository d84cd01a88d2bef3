"""Public wrapper of the paged decode-attention kernel.

A CPU tensor goes to the plain version (``ref.paged_attention_ref``); a
CUDA tensor goes to the hand-written CUDA kernel
(``csrc/paged_attention.cu``, built at first use and loaded with
``ctypes``), or the wrapper raises.  There is no fallback from the kernel
to the plain version on the card.

The kernel splits each sequence's positions across blocks
(:func:`split_plan`, a function of the table's width alone: the lengths
stay on the device); with more than one split a second, small kernel
merges the splits' partials from a workspace the wrapper allocates.  The
kernel reads q and the pools with 16-byte loads; a tensor that does not
start on a 16-byte boundary (no caller of the port passes one) is copied to
one that does (:func:`aligned`), so no input is refused for where it lies.

``paged_attention.launches`` counts wrapper calls that reached the card
(a plain integer the caller may reset), one a call whether it launched
one kernel or two, so a run can show that its decode path went through
the kernel once per layer per decode step.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (8, 12, 16, 64, 80, 128)
SUPPORTED_REPS = (1, 2, 4, 5, 7)
SUPPORTED_BLOCK_SIZES = (8, 16)
SPLIT_POSITIONS = 256  # positions a block takes: 16 pages of 16, 32 of 8
ALIGN = 16  # q and the pools are read with 16-byte loads (8-byte at bf16 hd 12)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's shared library."""
    lib = load_library(SOURCE, "paged_attention")
    fn = lib.repro_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def split_plan(nb: int, block_size: int) -> tuple[int, int]:
    """(pages a split, splits) for a table of ``nb`` pages of ``block_size``
    positions: a block takes SPLIT_POSITIONS positions, so a table of up to
    that many positions (the served llama3.2-1b ticks) is one split and
    needs no merge."""
    pages = SPLIT_POSITIONS // block_size
    return pages, -(-nb // pages)


def workspace_numel(S: int, H: int, hd: int, splits: int) -> int:
    """Floats of the splits' partials: acc [S, H, splits, hd], then m and l
    [S, H, splits]; none with one split."""
    return 0 if splits == 1 else S * H * splits * (hd + 2)


def check_inputs(q, k_pages, v_pages, block_tables, lengths) -> None:
    """Raise unless the kernel takes these tensors (any device: the shape,
    type and layout rules; the wrapper adds the device rule)."""
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(
            f"q must be [S,H,hd] and pages [N,bs,KV,hd], got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}"
        )
    S, H, hd = q.shape
    N, bs, KV, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(
            f"k/v pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
            f"match q head dim {hd}"
        )
    if q.dtype not in SUPPORTED_DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"type, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if H % KV or H // KV not in SUPPORTED_REPS:
        raise ValueError(f"H/KV = {H}/{KV}: rep must be one of {SUPPORTED_REPS}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if bs not in SUPPORTED_BLOCK_SIZES:
        raise ValueError(f"block_size {bs} not in {SUPPORTED_BLOCK_SIZES}")
    if block_tables.ndim != 2 or block_tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(
            f"block_tables must be [S={S}, nb] and lengths [S], got "
            f"{tuple(block_tables.shape)}, {tuple(lengths.shape)}"
        )
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it starts on an ALIGN-byte boundary, else a copy
    that does (a fresh allocation; a row of hd in SUPPORTED_HEAD_DIMS
    elements is a whole number of the kernel's loads, so every row then
    starts on a load's boundary)."""
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """Decode attention over a block-paged KV cache (one query/sequence).

    q: [S, H, hd]; k_pages/v_pages: [N, block_size, KV, hd] physical pool;
    block_tables: [S, nb] int32; lengths: [S] int32 valid positions (each
    at least 1 and at most nb * block_size) -> [S, H, hd] in q's type.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    check_inputs(q, k_pages, v_pages, block_tables, lengths)
    q, k_pages, v_pages = aligned(q), aligned(k_pages), aligned(v_pages)
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(
            f"paged_attention kernel needs every input on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    S, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    nb = block_tables.shape[1]
    pages, splits = split_plan(nb, bs)
    out = torch.empty_like(q)
    ws = (torch.empty(workspace_numel(S, H, hd, splits), dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = library().repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), S, H, KV, hd, bs, nb,
            SUPPORTED_DTYPES[q.dtype], pages, splits, hd**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)} {q.dtype}, pages {tuple(k_pages.shape)}"
        )
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
