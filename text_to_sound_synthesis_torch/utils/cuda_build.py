"""Build a CUDA source of this package into a shared library and load it.

The kernels have a plain C interface and are bound with ``ctypes``: ``nvcc``
compiles ``csrc/<name>.cu`` for ``sm_90a`` into ``<checkout>/build/kernels/``,
keyed by a hash of the sources and flags, at the first call on a machine with
a card. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# No --use_fast_math: the sampler's -70 clamps and log(1e-30) placeholders sit
# at the edge of the f32 range, where the fast intrinsics lose accuracy.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` (PyTorch's own search)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels of this package cannot be built")


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into ``lib<name>-<hash>.so``
    unless that file exists, then load it. Raises with nvcc's output on failure."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + paths:
        digest.update(p.name.encode() + p.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
               *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        (BUILD_DIR / f"lib{name}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    return ctypes.CDLL(str(so))
