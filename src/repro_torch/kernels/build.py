"""Build a CUDA source of the port into a shared library and load it.

Each kernel is plain CUDA C++ with a C entry point: ``nvcc`` compiles it
for Hopper (``sm_90a``) into ``build/repro_torch_kernels/`` under the
repository root (git-ignored) at first use, and ``ctypes`` loads it.  The
file name carries a hash of the source and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def build_shared_library(source: Path, name: str) -> Path:
    """Compile ``source`` unless an identical build exists; returns the
    ``.so`` path.  The compiler's ``-Xptxas=-v`` report (registers, shared
    memory, spills) is kept beside it as ``<name>-<hash>.log``."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load_library(source: Path, name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_shared_library(source, name)))
