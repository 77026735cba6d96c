"""Spectrogram transforms for the input pipeline.

A copy of ``text_to_sound_synthesis_tpu/data/transforms.py`` (the port never
imports the JAX package). Parity targets: ``Crop`` (``Codebook/specvqgan/modules/losses/vggishish/transforms.py``,
used by every dataset as ``CropImage([80, 848], random_crop)``) and
``StandardNormalizeAudio`` (train-set per-bin mean/std, used by the evaluation
feature extractor), plus the [0,1] -> [-1,1] model scaling
(``caps_dataset.py:62``). Numpy-only — these run in host data workers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["CropSpec", "StandardNormalize", "to_model_range", "from_model_range"]


class CropSpec:
    """Crop a (mel, time) spec to ``(mel_num, crop_len)``; random or centered."""

    def __init__(self, crop_shape: Sequence[int], random_crop: bool = False):
        self.mel_num, self.crop_len = int(crop_shape[0]), int(crop_shape[1])
        self.random_crop = random_crop

    def __call__(self, spec: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        H, W = spec.shape[-2], spec.shape[-1]
        if H < self.mel_num or W < self.crop_len:
            raise ValueError(f"spec {spec.shape} smaller than crop "
                             f"({self.mel_num}, {self.crop_len})")
        if self.random_crop:
            rng = rng or np.random.default_rng()
            top = int(rng.integers(0, H - self.mel_num + 1))
            left = int(rng.integers(0, W - self.crop_len + 1))
        else:
            top = (H - self.mel_num) // 2
            left = (W - self.crop_len) // 2
        return spec[..., top : top + self.mel_num, left : left + self.crop_len]


class StandardNormalize:
    """Per-mel-bin standardization with dataset statistics (means/stds files)."""

    def __init__(self, means: np.ndarray, stds: np.ndarray):
        self.means = np.asarray(means, np.float32).reshape(-1, 1)
        self.stds = np.asarray(stds, np.float32).reshape(-1, 1)

    @classmethod
    def from_txt(cls, means_path: str, stds_path: str) -> "StandardNormalize":
        return cls(np.loadtxt(means_path), np.loadtxt(stds_path))

    def __call__(self, spec: np.ndarray) -> np.ndarray:
        return (spec - self.means) / self.stds


def to_model_range(spec01: np.ndarray) -> np.ndarray:
    """[0, 1] stored spec -> [-1, 1] model input."""
    return 2.0 * spec01 - 1.0


def from_model_range(spec: np.ndarray) -> np.ndarray:
    return (spec + 1.0) / 2.0
