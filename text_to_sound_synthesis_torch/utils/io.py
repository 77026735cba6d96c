"""Audio / array IO without librosa or soundfile.

A copy of the JAX package's ``utils/io.py`` (numpy and scipy only). Covers
the reference's IO surface: 22 050 Hz mono loading (librosa.load semantics:
resample + normalize to [-1,1] float), PCM_24 wav writing
(``generate_samples_batch.py:184-186`` uses soundfile PCM_24), and .npy specs.
"""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np

__all__ = ["read_wav", "write_wav", "wav_bytes", "resample_poly"]


def read_wav(path: str, target_sr: int = 22050) -> Tuple[np.ndarray, int]:
    """Load a wav as mono float32 in [-1, 1], resampled to ``target_sr``."""
    import scipy.io.wavfile as wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    if target_sr and sr != target_sr:
        y = resample_poly(y, target_sr, sr)
        sr = target_sr
    return y, sr


def resample_poly(y: np.ndarray, up_sr: int, down_sr: int) -> np.ndarray:
    """Polyphase resampling via scipy (librosa.load's resampler equivalent)."""
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(up_sr, down_sr)
    return _rp(y, up_sr // g, down_sr // g).astype(np.float32)


def write_wav(path: str, sr: int, y: np.ndarray, subtype: str = "PCM_24") -> None:
    """Write mono float [-1,1] audio; PCM_24 (reference default) or PCM_16."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(wav_bytes(sr, y, subtype))


def wav_bytes(sr: int, y: np.ndarray, subtype: str = "PCM_24") -> bytes:
    """In-memory WAV encoding — the single implementation behind
    ``write_wav`` and the HTTP serving path. 24-bit packing is vectorized
    (the per-sample ``struct.pack`` loop cost ~100s of ms per 10 s clip)."""
    import io as _io

    y = np.clip(np.asarray(y, np.float64), -1.0, 1.0)
    buf = _io.BytesIO()
    if subtype == "PCM_16":
        import scipy.io.wavfile as wavfile

        wavfile.write(buf, sr, (y * 32767.0).astype(np.int16))
        return buf.getvalue()
    if subtype != "PCM_24":
        raise ValueError(f"unsupported subtype {subtype!r}")
    ints = np.round(y * 8388607.0).astype(np.int32)
    # little-endian 24-bit: view the <i4 samples as bytes, drop the top byte
    frames = (ints.astype("<i4").reshape(-1, 1).view(np.uint8)[:, :3]
              .tobytes())
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(sr)
        w.writeframes(frames)
    return buf.getvalue()
