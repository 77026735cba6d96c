"""ctypes bindings for the C++ batched .npy mel loader (npy_batch.cc).

A copy of the JAX package's ``native/npy_loader.py`` for the port. The first
call compiles ``npy_batch.cc`` with ``g++ -O3 -shared`` into
``$T2S_NATIVE_CACHE`` (default ``build/native/`` at the repository's root,
which git ignores), keyed by a source hash, so editing the .cc rebuilds and
concurrent processes share one library. ``T2S_NATIVE_LOADER=0`` turns the
path off; where the build fails, the datasets read with numpy instead, as in
the JAX package.

The ABI is flat C (pointer arrays + an error buffer), which ctypes covers
with no build-time Python dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "npy_batch.cc")
_lock = threading.Lock()
_lib = None          # loaded CDLL
_lib_failed = False  # build/load failed once -> stop retrying


_DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")


def _cache_dir() -> str:
    return os.environ.get("T2S_NATIVE_CACHE", _DEFAULT_CACHE)


def _build() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = _cache_dir()
    so_path = os.path.join(cache, f"libt2s_npy_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)  # atomic: racing builders converge
    lib = ctypes.CDLL(so_path)
    lib.t2s_load_mel_batch.restype = ctypes.c_int
    lib.t2s_load_mel_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.t2s_npy_shape.restype = ctypes.c_int
    lib.t2s_npy_shape.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_char_p, ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    """True when the env allows the native path and the library builds."""
    global _lib, _lib_failed
    if os.environ.get("T2S_NATIVE_LOADER", "1") == "0":
        return False
    if _lib is not None:
        return True
    if _lib_failed:
        return False
    with _lock:
        if _lib is not None:
            return True
        if _lib_failed:
            return False
        try:
            _lib = _build()
            return True
        except Exception:
            _lib_failed = True
            return False


def npy_shape(path: str) -> Tuple[int, int]:
    """(H, W) of a 2-D .npy from its header alone (no data read)."""
    if not native_available():
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, _ = np.lib.format._read_array_header(f, version)
        if len(shape) != 2:
            raise ValueError(f"{path}: expected 2-D, got {shape}")
        return int(shape[0]), int(shape[1])
    H = ctypes.c_longlong()
    W = ctypes.c_longlong()
    err = ctypes.create_string_buffer(512)
    rc = _lib.t2s_npy_shape(os.fspath(path).encode(), ctypes.byref(H),
                            ctypes.byref(W), err, len(err))
    if rc:
        raise IOError(err.value.decode(errors="replace"))
    return H.value, W.value


def load_mel_batch(
    paths: Sequence[str],
    mel_num: int,
    crop_len: int,
    tops: Optional[Sequence[int]] = None,
    lefts: Optional[Sequence[int]] = None,
    *,
    to_model_range: bool = True,
    nthreads: int = 0,
) -> Optional[np.ndarray]:
    """Load + crop + (optionally) scale a batch of mels -> (B, mel_num, crop_len)
    float32. ``tops``/``lefts`` of -1 (or None) mean centered crop. Returns
    None when the native path is unavailable (caller falls back to Python);
    raises IOError on an actual load failure (bad file, crop out of range)."""
    if not native_available():
        return None
    n = len(paths)
    out = np.empty((n, mel_num, crop_len), dtype=np.float32)
    if n == 0:
        return out
    c_paths = (ctypes.c_char_p * n)(*[os.fspath(p).encode() for p in paths])
    t = np.asarray(tops if tops is not None else [-1] * n, dtype=np.int64)
    l = np.asarray(lefts if lefts is not None else [-1] * n, dtype=np.int64)
    if t.shape != (n,) or l.shape != (n,):
        # the C side indexes tops/lefts[0..n) — a short list would read OOB
        raise ValueError(
            f"tops/lefts must have one entry per path: got {t.shape[0] if t.ndim else 0}/"
            f"{l.shape[0] if l.ndim else 0} for {n} paths")
    err = ctypes.create_string_buffer(512)
    rc = _lib.t2s_load_mel_batch(
        c_paths, n, mel_num, crop_len,
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        l.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        1 if to_model_range else 0, nthreads, err, len(err),
    )
    if rc:
        raise IOError(err.value.decode(errors="replace"))
    return out
