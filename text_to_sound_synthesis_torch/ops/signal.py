"""Signal processing layer (L0): wav -> mel-spectrogram, self-contained.

Port of ``text_to_sound_synthesis_tpu/ops/signal.py``: the reference's
canonical mel recipe
(``Codebook/feature_extraction/extract_mel_spectrogram.py:141-163``) and the
vocoder-training log-mel (``Diffsound/vocoder/modules.py:26-69``) without
librosa. The numpy part (the Slaney mel filterbank, the host STFT and dB
chain) is the JAX package's, copied unchanged; the batched device part
(``stft_magnitude``, ``wav_to_mel``, ``audio_to_logmel``) is written on
torch. Griffin-Lim and the mel -> wav inversion wait for the port's
stage-1 and vocoder training.

Canonical recipe (22 050 Hz, 10 s clips):
  ``|STFT(nfft=1024, hop=256, hann, center, reflect)|**1 -> mel(80, fmin=125,
  fmax=7600, slaney) -> max(1e-5) -> log10 -> *20 -> -20 -> +100 -> /100 ->
  clip[0,1] -> trim to 860 frames``.
Specs are stored in [0, 1]; models consume ``2*x - 1`` (caps_dataset.py:62).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "MelConfig",
    "CANONICAL",
    "mel_filterbank",
    "hann_window",
    "stft_magnitude_np",
    "wav_to_mel_np",
    "denormalize_mel_np",
    "stft_magnitude",
    "wav_to_mel",
    "audio_to_logmel",
]


class MelConfig:
    """Static parameters of the mel pipeline (hashable; usable as a jit static arg)."""

    def __init__(
        self,
        sample_rate: int = 22050,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: int | None = None,
        n_mels: int = 80,
        fmin: float = 125.0,
        fmax: float | None = 7600.0,
        spec_power: float = 1.0,
        max_frames: int = 860,
    ):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length or n_fft
        self.n_mels = n_mels
        self.fmin = fmin
        self.fmax = fmax if fmax is not None else sample_rate / 2
        self.spec_power = spec_power
        self.max_frames = max_frames

    def _key(self):
        return (
            self.sample_rate, self.n_fft, self.hop_length, self.win_length,
            self.n_mels, self.fmin, self.fmax, self.spec_power, self.max_frames,
        )

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, MelConfig) and self._key() == other._key()


#: The canonical Diffsound recipe (see module docstring).
CANONICAL = MelConfig()


# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale + Slaney area normalization, librosa defaults)
# ---------------------------------------------------------------------------

def _hz_to_mel(freq: np.ndarray, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above.
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    above = freq >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    above = mels >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft//2).

    Numerically equivalent to ``librosa.filters.mel`` with default arguments
    (Slaney scale, Slaney per-filter area normalization), which both the dataset
    recipe (fmin=125, fmax=7600) and MelGAN's ``Audio2Mel`` (fmin=0, fmax=None)
    rely on.
    """
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = _hz_to_mel(np.array([fmin, fmax]), htk=htk)
    mel_f = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2), htk=htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm: {norm!r}")
    return weights.astype(dtype)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (== torch.hann_window == scipy fftbins=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def _fft_window(win_length: int, n_fft: int, dtype=np.float32) -> np.ndarray:
    """Hann window center-padded to n_fft (librosa's pad_center convention)
    — shared by the numpy and JAX STFT paths so win_length < n_fft behaves
    identically on both."""
    window = hann_window(win_length, dtype=dtype)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


# ---------------------------------------------------------------------------
# Host-side (numpy) pipeline — offline dataset preparation
# ---------------------------------------------------------------------------

def stft_magnitude_np(
    y: np.ndarray,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> np.ndarray:
    """|STFT| of a mono signal, shape (1 + n_fft//2, n_frames)."""
    win_length = win_length or n_fft
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    n_frames = 1 + (len(y) - n_fft) // hop_length
    window = _fft_window(win_length, n_fft, dtype=np.float64)
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=1)).T


def wav_to_mel_np(y: np.ndarray, cfg: MelConfig = CANONICAL) -> np.ndarray:
    """wav -> normalized mel in [0, 1], shape (n_mels, <=max_frames).

    The canonical ``TRANSFORMS`` chain (extract_mel_spectrogram.py:141-151).
    """
    spec = stft_magnitude_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length) ** cfg.spec_power
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, dtype=np.float64)
    mel = basis @ spec
    mel = np.maximum(1e-5, mel)
    mel = (np.log10(mel) * 20.0 - 20.0 + 100.0) / 100.0
    mel = np.clip(mel, 0.0, 1.0)
    return mel[:, : cfg.max_frames].astype(np.float32)


def denormalize_mel_np(mel01: np.ndarray, cfg: MelConfig = CANONICAL) -> np.ndarray:
    """[0, 1] normalized mel -> linear mel power (inverse of the dB chain)."""
    return 10.0 ** ((mel01 * 100.0 - 100.0 + 20.0) / 20.0)


# ---------------------------------------------------------------------------
# Device-side (torch) pipeline — batched, on the input's device
# ---------------------------------------------------------------------------

def _frame(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft), frames ``hop`` apart (a view)."""
    return y.unfold(-1, n_fft, hop)


def _pad_last(y: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad the last axis by ``p`` on both sides (``F.pad``'s modes)."""
    flat = y.reshape(-1, 1, y.shape[-1])
    return F.pad(flat, (p, p), mode=mode).reshape(*y.shape[:-1], y.shape[-1] + 2 * p)


def _mel_basis(cfg: MelConfig, like: torch.Tensor) -> torch.Tensor:
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    return torch.from_numpy(basis).to(like)


def stft_magnitude(y: torch.Tensor, cfg: MelConfig = CANONICAL, center: bool = True,
                   pad_mode: str = "reflect") -> torch.Tensor:
    """Batched |STFT|: (..., samples) -> (..., n_bins, n_frames)."""
    if center:
        y = _pad_last(y, cfg.n_fft // 2, pad_mode)
    frames = _frame(y, cfg.n_fft, cfg.hop_length)
    window = torch.from_numpy(_fft_window(cfg.win_length, cfg.n_fft)).to(y)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1)
    return spec.abs().transpose(-1, -2)


def wav_to_mel(y: torch.Tensor, cfg: MelConfig = CANONICAL) -> torch.Tensor:
    """Batched canonical recipe: (..., samples) -> (..., n_mels, T)."""
    spec = stft_magnitude(y, cfg) ** cfg.spec_power
    mel = torch.einsum("mf,...ft->...mt", _mel_basis(cfg, spec), spec)
    mel = torch.clamp(mel, min=1e-5)
    mel = (torch.log10(mel) * 20.0 - 20.0 + 100.0) / 100.0
    mel = torch.clamp(mel, 0.0, 1.0)
    return mel[..., : cfg.max_frames]


def audio_to_logmel(audio: torch.Tensor, cfg: MelConfig | None = None) -> torch.Tensor:
    """MelGAN-training log10-mel (vocoder ``Audio2Mel``, modules.py:54-69).

    (..., samples) -> (..., n_mels, n_frames); reflect-pads by
    (n_fft - hop)/2 on both sides, center=False, fmin=0, fmax=None.
    """
    cfg = cfg or MelConfig(fmin=0.0, fmax=None, max_frames=10**9)
    audio = _pad_last(audio, (cfg.n_fft - cfg.hop_length) // 2, "reflect")
    spec = stft_magnitude(audio, cfg, center=False)
    mel = torch.einsum("mf,...ft->...mt", _mel_basis(cfg, spec), spec)
    return torch.log10(torch.clamp(mel, min=1e-5))
