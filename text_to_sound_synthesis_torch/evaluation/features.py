"""Melception feature extraction over sample directories (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/evaluation/features.py``. Parity target:
``get_featuresdict`` + ``FakesFolder`` (``Codebook/evaluate.py:61-135``,
``Codebook/evaluation/datasets/fakes.py:28-76``): scan a directory of
generated ``.npy`` mels (or the ground-truth set), standardize with the
train-set mel statistics, run Melception batched on the module's device,
gather feature dicts (+ file paths for the KL grouping).

One forward a batch, the last batch as short as it comes (the JAX package
pads it to a static shape for XLA's compile cache; the features are the
same). Convs and matmuls run in full f32: PyTorch's default lets cuDNN run
f32 convs on TF32 on the card, which the feature extractor does not (the
CPU and the card then agree to f32 rounding). ``multihost=True`` shards the
files by the ``torch.distributed`` rank (the DDP ``DistributedSampler`` +
``all_gather_object`` path, evaluate.py:123-132) and gathers them in JAX's
``process_allgather`` order: rank p holds files p, p + P, ...; every rank's
features are padded to the largest shard, gathered, and the padding dropped.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.distributed import all_gather_cat, get_rank, get_world_size
from ..utils.dtype import full_f32
from .metrics import calculate_fid, calculate_isc, calculate_kid, calculate_kl

__all__ = ["FakesFolder", "extract_features", "evaluate_folders"]


class FakesFolder:
    """Directory of generated ``*.npy`` mel files (values in [0,1] or [-1,1])."""

    def __init__(self, root: str, extension: str = ".npy", from_minus_one_one: bool = False):
        self.files = sorted(
            os.path.join(dp, f)
            for dp, _, fs in os.walk(root)
            for f in fs
            if f.endswith(extension)
        )
        if not self.files:
            raise FileNotFoundError(f"no {extension} files under {root}")
        self.from_minus_one_one = from_minus_one_one

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int):
        spec = np.load(self.files[i]).astype(np.float32)
        spec = np.squeeze(spec)
        if self.from_minus_one_one:
            spec = (spec + 1.0) / 2.0
        return spec, self.files[i]


def _gather(result: Dict[str, np.ndarray], folder, n: int, world: int) -> Dict:
    """Every rank's strided shard -> the whole set, in the JAX package's
    ``process_allgather`` order (rank by rank, each shard in its own order)."""
    counts = [len(range(p, n, world)) for p in range(world)]
    m = max(counts)
    comm = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    gathered = {}
    for k, v in result.items():
        if k == "file_path_":
            continue
        pad = np.zeros((m - len(v),) + v.shape[1:], v.dtype)
        g = all_gather_cat(torch.from_numpy(np.concatenate([v, pad])).to(comm)).cpu().numpy()
        g = g.reshape((world, m) + v.shape[1:])
        gathered[k] = np.concatenate([g[p, :counts[p]] for p in range(world)], axis=0)
    # paths are strings: rebuild them from the folder's deterministic order
    files = getattr(folder, "files", None)
    path_of = (lambda i: files[i]) if files is not None else (lambda i: folder[i][1])
    gathered["file_path_"] = [path_of(i) for p in range(world) for i in range(p, n, world)]
    return gathered


@torch.no_grad()
def extract_features(
    model: nn.Module,
    folder,
    *,
    batch_size: int = 16,
    means: Optional[np.ndarray] = None,
    stds: Optional[np.ndarray] = None,
    crop_len: Optional[int] = None,
    multihost: bool = False,
) -> Dict[str, np.ndarray]:
    """Returns {'<tap>': (N, D) arrays, 'file_path_': [paths]}, Melception
    run on its own device. ``folder`` is a ``FakesFolder`` or any sequence of
    (spec, path) pairs.

    ``multihost=True`` shards the file list across the process group's ranks
    and gathers the results (no-op outside a group or in a group of one)."""
    mean_v = np.asarray(means, np.float32).reshape(-1, 1) if means is not None else 0.0
    std_v = np.asarray(stds, np.float32).reshape(-1, 1) if stds is not None else 1.0
    device = next(model.parameters()).device

    n = len(folder)
    world = get_world_size() if multihost else 1
    if world > n:
        raise ValueError(f"{n} files cannot be sharded over {world} ranks")
    indices = list(range(n))[get_rank()::world] if world > 1 else list(range(n))

    feats: Dict[str, List[np.ndarray]] = {}
    paths: List[str] = []
    with full_f32():
        for start in range(0, len(indices), batch_size):
            idx = indices[start: start + batch_size]
            specs, batch_paths = zip(*[folder[i] for i in idx])
            specs = [s[:, :crop_len] if crop_len else s for s in specs]
            batch = np.stack([(s - mean_v) / std_v for s in specs]).astype(np.float32)
            out = model(torch.from_numpy(batch).to(device))
            for k, v in out.items():
                feats.setdefault(k, []).append(v.float().cpu().numpy())
            paths.extend(batch_paths)
    result = {k: np.concatenate(v, axis=0) for k, v in feats.items()}
    result["file_path_"] = paths
    if world > 1:
        return _gather(result, folder, n, world)
    return result


def evaluate_folders(
    model: nn.Module,
    generated_dir: str,
    reference_dir: str,
    *,
    dataset_name: str = "caps",
    batch_size: int = 16,
    means=None,
    stds=None,
    crop_len: Optional[int] = None,
    have_fid: bool = True,
    have_isc: bool = True,
    have_kid: bool = True,
    have_kl: bool = True,
    kid_subset_size: int = 1000,
    isc_splits: int = 10,
) -> Dict[str, float]:
    """The ``Codebook/evaluate.py`` pipeline over two sample directories."""
    f1 = extract_features(model, FakesFolder(generated_dir),
                          batch_size=batch_size, means=means, stds=stds, crop_len=crop_len)
    f2 = extract_features(model, FakesFolder(reference_dir),
                          batch_size=batch_size, means=means, stds=stds, crop_len=crop_len)
    out: Dict[str, float] = {}
    if have_kl:
        out.update(calculate_kl(f1["logits"], f1["file_path_"],
                                f2["logits"], f2["file_path_"], dataset_name))
    if have_isc:
        out.update(calculate_isc(f1["logits"], rng_seed=2020, samples_shuffle=True,
                                 splits=isc_splits))
    if have_fid:
        out.update(calculate_fid(f1["2048"], f2["2048"]))
    if have_kid:
        out.update(calculate_kid(f1["2048"], f2["2048"], subsets=100,
                                 subset_size=kid_subset_size))
    return out
