"""Datasets: precomputed mel .npy files + caption manifests.

A copy of ``text_to_sound_synthesis_tpu/data/datasets.py`` for the port,
registered under the same config targets. Parity targets: ``CapsDataset`` (``Diffsound/sound_synthesis/data/caps_dataset.py:21-77``)
and the ``AudiosetDataset`` family (``audioset_dataset.py``): filename manifest
(pickle or txt), per-clip caption txt (one caption per line, one chosen at
random per epoch), mel ``.npy`` load, crop to (80, 848), scale to [-1, 1].

Layout (configurable; defaults mirror the reference minus its hard-coded
cluster prefixes):
    <data_root>/<phase>/filenames.pickle         # list of clip names
    <data_root>/text/<phase>/<name>.txt          # one caption per line
    <mel_root or data_root/features>/<phase>/melspec_10s_22050hz/<name>_mel.npy
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from ..utils.config import register
from .transforms import CropSpec, to_model_range

__all__ = ["CapsDataset", "AudiosetDataset", "ArrayDataset"]


def _draw_crop(crop: CropSpec, path: str, rng: np.random.Generator):
    """Crop offsets for one file, consuming rng exactly like CropSpec.__call__
    (top then left) so the batched and per-item paths share one stream.
    -1 means centered (resolved by the loader, native or Python)."""
    if not crop.random_crop:
        return -1, -1
    from ..native import npy_shape

    H, W = npy_shape(path)
    if H < crop.mel_num or W < crop.crop_len:
        raise ValueError(f"spec ({H}, {W}) smaller than crop "
                         f"({crop.mel_num}, {crop.crop_len})")
    top = int(rng.integers(0, H - crop.mel_num + 1))
    left = int(rng.integers(0, W - crop.crop_len + 1))
    return top, left


def _load_mels(paths, crop: CropSpec, tops, lefts) -> np.ndarray:
    """Batched crop+scale load: C++ thread pool when available, else numpy.
    Both return bit-identical float32 (tests/test_native_loader.py)."""
    from ..native import load_mel_batch

    try:
        mels = load_mel_batch(paths, crop.mel_num, crop.crop_len, tops, lefts)
    except IOError:
        mels = None  # e.g. fortran-order/odd-dtype file: numpy handles it
    if mels is not None:
        return mels
    out = np.empty((len(paths), crop.mel_num, crop.crop_len), np.float32)
    for i, p in enumerate(paths):
        spec = np.load(p)
        H, W = spec.shape[-2], spec.shape[-1]
        t = (H - crop.mel_num) // 2 if tops[i] < 0 else tops[i]
        l = (W - crop.crop_len) // 2 if lefts[i] < 0 else lefts[i]
        win = spec[t : t + crop.mel_num, l : l + crop.crop_len]
        out[i] = to_model_range(win).astype(np.float32)
    return out


class _MelCaptionDataset:
    """Shared implementation: name manifest + mel files + caption dict."""

    def __init__(
        self,
        data_root: str,
        phase: str = "train",
        mel_num: int = 80,
        spec_len: int = 860,
        spec_crop_len: int = 848,
        random_crop: bool = False,
        mel_root: Optional[str] = None,
        im_preprocessor_config=None,  # accepted for config parity (unused: it
        #                               was an ImageNet image augmenter no-op)
    ):
        self.data_root = data_root
        self.phase = phase
        self.crop = CropSpec([mel_num, spec_crop_len], random_crop)
        mel_phase = "train" if phase == "train" else "val"
        base = mel_root or os.path.join(data_root, "features")
        self.mel_dir = os.path.join(base, mel_phase, "melspec_10s_22050hz")
        self.names = self._load_names()
        # captions load LAZILY with a cache: eagerly opening one .txt per
        # manifest entry stalls construction for minutes at AudioSet scale
        # (~2M clips) on a 1-core host
        self._captions: dict = {}

    def _load_names(self) -> List[str]:
        pkl = os.path.join(self.data_root, self.phase, "filenames.pickle")
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                return list(pickle.load(f))
        txt = os.path.join(self.data_root, self.phase, "filenames.txt")
        with open(txt) as f:
            return [line.strip() for line in f if line.strip()]

    def captions(self, name: str) -> List[str]:
        caps = self._captions.get(name)
        if caps is None:
            caps = self._captions[name] = self._load_captions(name)
        return caps

    def _load_captions(self, name: str) -> List[str]:
        path = os.path.join(self.data_root, "text", self.phase, name + ".txt")
        with open(path) as f:
            caps = [line.rstrip("\n") for line in f if line.strip()]
        return caps or [""]

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        name = self.names[index]
        spec = np.load(os.path.join(self.mel_dir, name + "_mel.npy"))
        spec = self.crop(spec, rng)
        image = to_model_range(spec)[None, :, :].astype(np.float32)  # (1, H, W)
        caps = self.captions(name)
        caption = caps[int(rng.integers(0, len(caps)))].lower()
        return {"image": image, "text": caption}

    def load_batch(self, indices, rng: Optional[np.random.Generator] = None):
        """Batched fast path (C++ loader): collated {'image', 'text'} equal to
        stacking __getitem__ over ``indices`` with the same rng."""
        rng = rng or np.random.default_rng()
        paths, tops, lefts, texts = [], [], [], []
        for index in indices:
            name = self.names[int(index)]
            path = os.path.join(self.mel_dir, name + "_mel.npy")
            top, left = _draw_crop(self.crop, path, rng)
            paths.append(path)
            tops.append(top)
            lefts.append(left)
            caps = self.captions(name)
            texts.append(caps[int(rng.integers(0, len(caps)))].lower())
        mels = _load_mels(paths, self.crop, tops, lefts)
        return {"image": mels[:, None, :, :], "text": texts}


@register(
    "text_to_sound_synthesis_tpu.data.CapsDataset",
    "sound_synthesis.data.caps_dataset.CapsDataset",
    "sound_synthesis.data.caps_dataset.CapsDatasetAll",
)
class CapsDataset(_MelCaptionDataset):
    """AudioCaps: ~5 captions per clip (train has 1, val/test have 5)."""


@register(
    "text_to_sound_synthesis_tpu.data.AudiosetDataset",
    "sound_synthesis.data.audioset_dataset.AudiosetDataset",
    "sound_synthesis.data.audioset_dataset.AudiosetDatasetTxt",
)
class AudiosetDataset(_MelCaptionDataset):
    """AudioSet pretraining set: label-derived masked captions in the same
    manifest layout (the reference's .pkl/.npz caption variants collapse to
    the txt form after preprocessing with tools/prepare_data.py)."""


def make_split_files(split_path: str, spec_dir_path: str, suffix: str = "_mel.npy",
                     train_frac: float = 0.9, seed: int = 0) -> None:
    """Scan ``spec_dir_path`` (with a ``*`` class wildcard) and write
    ``<prefix>_train.txt``/``_valid.txt`` of ``<class>/<vid>`` rows
    (``Codebook/specvqgan/data/caps.py:15-63`` behavior)."""
    import glob as _glob

    # the class is the path component the '*' wildcard matched — NOT the
    # file's immediate parent: the shipped configs put the wildcard mid-path
    # ('features/*/melspec_10s_22050hz'), and __getitem__ substitutes the
    # class back into that same position (spec_dir_path.replace('*', cls))
    parts = os.path.normpath(spec_dir_path).split(os.sep)
    star_idx = next((i for i, p in enumerate(parts) if "*" in p), None)

    rows = []
    for path in sorted(_glob.glob(os.path.join(spec_dir_path, "*" + suffix))):
        vid = os.path.basename(path)[: -len(suffix)]
        if star_idx is not None:
            cls = os.path.normpath(path).split(os.sep)[star_idx]
        else:
            cls = os.path.basename(os.path.dirname(path))
        rows.append(f"{cls}/{vid}")
    rng = np.random.default_rng(seed)
    rng.shuffle(rows)
    n_train = int(len(rows) * train_frac)
    base = split_path
    for tag in ("train", "valid", "test"):
        if base.endswith(f"_{tag}.txt"):
            base = base[: -len(f"_{tag}.txt")]
    with open(base + "_train.txt", "w") as f:
        f.write("\n".join(rows[:n_train]) + "\n")
    with open(base + "_valid.txt", "w") as f:
        f.write("\n".join(rows[n_train:]) + "\n")


@register(
    "text_to_sound_synthesis_tpu.data.SpecsDataset",
    "specvqgan.data.caps.VASSpecs",
    "specvqgan.data.audioset.VASSpecs",
)
class SpecsDataset:
    """Stage-1 codebook-training dataset: ``<class>/<vid>`` split rows, mels
    from a class-wildcard directory (``VASSpecs``, caps.py:88-139). Items carry
    ``image`` in [-1,1], ``label``/``target``, and ``file_path_``."""

    def __init__(
        self,
        split: str,
        spec_dir_path: str,
        split_path: Optional[str] = None,
        mel_num: int = 80,
        spec_len: int = 860,
        spec_crop_len: int = 848,
        random_crop: bool = False,
        crop_coord=None,
        for_which_class: Optional[str] = None,
        feat_suffix: str = "_mel.npy",
        cls_token_dir_path: Optional[str] = None,
        feat_dim: int = 512,
    ):
        self.spec_dir_path = spec_dir_path
        self.feat_suffix = feat_suffix
        self.split_path = split_path or os.path.join(
            os.path.dirname(spec_dir_path.replace("*", "")), f"split_{split}.txt"
        )
        if not os.path.exists(self.split_path):
            make_split_files(self.split_path, spec_dir_path, feat_suffix)
            base = self.split_path
            for tag in ("train", "valid", "test"):
                if base.endswith(f"_{tag}.txt"):
                    base = base[: -len(f"_{tag}.txt")]
            self.split_path = f"{base}_{'valid' if split in ('valid', 'test') else 'train'}.txt"
        with open(self.split_path) as f:
            rows = [r for r in f.read().splitlines() if r]
        if for_which_class:
            rows = [r for r in rows if r.startswith(for_which_class)]
        self.rows = rows
        classes = sorted({r.split("/")[0] for r in rows})
        self.label2target = {c: i for i, c in enumerate(classes)}
        self.crop = CropSpec([mel_num, spec_crop_len], random_crop)
        # optional text-feature conditioning (cls_token_512 / _768 dirs of
        # per-clip .txt vectors, used by the AR baseline's conditioned variant)
        self.cls_token_dir_path = cls_token_dir_path
        self.feat_dim = feat_dim

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        cls, vid = self.rows[index].split("/")
        path = os.path.join(self.spec_dir_path.replace("*", cls), vid + self.feat_suffix)
        spec = self.crop(np.load(path), rng)
        item = {
            "image": to_model_range(spec).astype(np.float32),
            "label": cls,
            "target": self.label2target[cls],
            "file_path_": path,
        }
        if self.cls_token_dir_path:
            fpath = os.path.join(self.cls_token_dir_path.replace("*", cls), vid + ".txt")
            feats = np.loadtxt(fpath, dtype=np.float32).reshape(-1)[: self.feat_dim]
            item["feature"] = feats.reshape(self.feat_dim, 1)  # (D, T=1) channel-major
        return item

    def load_batch(self, indices, rng: Optional[np.random.Generator] = None):
        """Batched fast path (C++ loader): collated dict equal to stacking
        __getitem__ over ``indices`` with the same rng."""
        rng = rng or np.random.default_rng()
        paths, tops, lefts, labels, feats = [], [], [], [], []
        for index in indices:
            cls, vid = self.rows[int(index)].split("/")
            path = os.path.join(self.spec_dir_path.replace("*", cls),
                                vid + self.feat_suffix)
            top, left = _draw_crop(self.crop, path, rng)
            paths.append(path)
            tops.append(top)
            lefts.append(left)
            labels.append(cls)
            if self.cls_token_dir_path:
                fpath = os.path.join(self.cls_token_dir_path.replace("*", cls),
                                     vid + ".txt")
                f = np.loadtxt(fpath, dtype=np.float32).reshape(-1)[: self.feat_dim]
                feats.append(f.reshape(self.feat_dim, 1))
        mels = _load_mels(paths, self.crop, tops, lefts)
        batch = {
            "image": mels,
            "label": labels,
            "target": np.asarray([self.label2target[c] for c in labels]),
            "file_path_": paths,
        }
        if self.cls_token_dir_path:
            batch["feature"] = np.stack(feats)
        return batch


class ArrayDataset:
    """In-memory dataset for tests/synthetic benchmarks."""

    def __init__(self, images: np.ndarray, texts: Sequence[str]):
        assert len(images) == len(texts)
        self.images = images
        self.texts = list(texts)

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, index: int, rng=None):
        return {"image": self.images[index], "text": self.texts[index]}
