"""Fidelity metrics: FID / Inception Score / KID / per-clip KL — numpy.

The port's own copy of ``text_to_sound_synthesis_tpu/evaluation/metrics.py``
(numpy and scipy only; the port imports nothing of the JAX package), so both
packages score the same features to the same numbers (one change: ``sqrtm``
is called without ``disp``, which newer scipy dropped; the root is the same).
Math identical to the reference implementations (``Codebook/evaluation/metrics/{fid,isc,kid,kl}.py``), torch-free:

* FID on 2048-d pool features: Frechet distance with scipy ``sqrtm`` and the
  near-singular eps fallback (fid.py:5-63);
* ISc on logits: exp of mean split-KL to the split marginal (isc.py:5-31);
* KID: unbiased polynomial-kernel MMD^2 over random subsets (kid.py:7-72);
* KL: softmax(logits) of generated samples vs their source clip's ground truth,
  grouped by shared key (multiple samples per caption), summed KL / N (kl.py:26-78).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.linalg

__all__ = [
    "calculate_fid",
    "calculate_isc",
    "calculate_kid",
    "calculate_kl",
    "path_to_sharedkey",
]


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def calculate_fid(features_1: np.ndarray, features_2: np.ndarray, eps: float = 1e-6) -> Dict[str, float]:
    """Frechet distance between Gaussian fits of two feature sets (N_i, D)."""
    mu1, mu2 = features_1.mean(0), features_2.mean(0)
    sigma1 = np.cov(features_1, rowvar=False)
    sigma2 = np.cov(features_2, rowvar=False)

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"large imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    fid = diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    return {"frechet_inception_distance": float(fid)}


def calculate_isc(
    features: np.ndarray, rng_seed: int = 2020, samples_shuffle: bool = True, splits: int = 10
) -> Dict[str, float]:
    """Inception score over logits (N, C)."""
    N = features.shape[0]
    if samples_shuffle:
        rng = np.random.RandomState(rng_seed)
        features = features[rng.permutation(N), :]
    features = features.astype(np.float64)
    p = _softmax(features, axis=1)
    log_p = np.log(p)

    scores = []
    for i in range(splits):
        pc = p[(i * N // splits) : ((i + 1) * N // splits), :]
        log_pc = log_p[(i * N // splits) : ((i + 1) * N // splits), :]
        if len(pc) == 0:  # more splits than samples
            continue
        q = pc.mean(axis=0, keepdims=True)
        kl = (pc * (log_pc - np.log(q))).sum(axis=1).mean()
        scores.append(np.exp(kl))
    return {
        "inception_score_mean": float(np.mean(scores)),
        "inception_score_std": float(np.std(scores)),
    }


def _polynomial_kernel(X, Y, degree=3, gamma=None, coef0=1):
    if gamma in (None, "none", "null", "None"):
        gamma = 1.0 / X.shape[1]
    return (X @ Y.T * gamma + coef0) ** degree


def _polynomial_mmd2(f1, f2, degree, gamma, coef0) -> float:
    K_XX = _polynomial_kernel(f1, f1, degree, gamma, coef0)
    K_YY = _polynomial_kernel(f2, f2, degree, gamma, coef0)
    K_XY = _polynomial_kernel(f1, f2, degree, gamma, coef0)
    m = K_XX.shape[0]
    kt_xx = K_XX.sum() - np.trace(K_XX)
    kt_yy = K_YY.sum() - np.trace(K_YY)
    mmd2 = (kt_xx + kt_yy) / (m * (m - 1)) - 2 * K_XY.sum() / (m * m)
    return float(mmd2)


def calculate_kid(
    features_1: np.ndarray,
    features_2: np.ndarray,
    subsets: int = 100,
    subset_size: int = 1000,
    degree: int = 3,
    gamma=None,
    coef0: int = 1,
    rng_seed: int = 2020,
) -> Dict[str, float]:
    subset_size = min(subset_size, len(features_1), len(features_2))
    rng = np.random.RandomState(rng_seed)
    mmds = np.zeros(subsets)
    for i in range(subsets):
        f1 = features_1[rng.choice(len(features_1), subset_size, replace=False)]
        f2 = features_2[rng.choice(len(features_2), subset_size, replace=False)]
        mmds[i] = _polynomial_mmd2(f1, f2, degree, gamma, coef0)
    return {
        "kernel_inception_distance_mean": float(np.mean(mmds)),
        "kernel_inception_distance_std": float(np.std(mmds)),
    }


def path_to_sharedkey(path: str, dataset_name: str, classes: Optional[Sequence[str]] = None) -> str:
    """Group generated sample files back to their source clip (kl.py:4-24)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    name = dataset_name.lower()
    if name in ("vggsound", "caps"):
        return stem.replace("_mel", "").split("_sample_")[0]
    if name == "vas":
        classes = sorted(classes or [])
        target_to_label = {f"cls_{i}": c for i, c in enumerate(classes)}
        for folder_cls_name, label in target_to_label.items():
            path = path.replace(folder_cls_name, label).replace("melspec_10s_22050hz/", "")
        parent = os.path.basename(os.path.dirname(path))
        stem = os.path.splitext(os.path.basename(path))[0]
        return parent + "_" + stem.replace("_mel", "").split("_sample_")[0]
    raise NotImplementedError(dataset_name)


def calculate_kl(
    logits_1: np.ndarray,
    paths_1: Sequence[str],
    logits_2: np.ndarray,
    paths_2: Sequence[str],
    dataset_name: str = "caps",
    classes: Optional[Sequence[str]] = None,
    eps: float = 1e-6,
) -> Dict[str, float]:
    """KL(ground truth || prediction) on class posteriors, one term per
    generated sample, ground-truth logits replicated across the clip's samples."""
    p1 = {p: f for p, f in zip(paths_1, logits_1)}
    p2 = {p: f for p, f in zip(paths_2, logits_2)}
    grouped_1: Dict[str, List[np.ndarray]] = {
        path_to_sharedkey(p, dataset_name, classes): [] for p in paths_1
    }
    for path, feat in p1.items():
        grouped_1[path_to_sharedkey(path, dataset_name, classes)].append(feat)
    feats_1, feats_2 = [], []
    for path, feat2 in p2.items():
        key = path_to_sharedkey(path, dataset_name, classes)
        samples = grouped_1.get(key, [])
        feats_1.extend(samples)
        feats_2.extend([feat2] * len(samples))
    if not feats_1:
        raise ValueError(
            "KL grouping found no overlapping clip keys between the generated "
            "and ground-truth sets — generated files must be named "
            "<clip>_sample_<i>.npy with <clip> matching the ground-truth "
            "<clip>_mel.npy names (generate from the val csv)")
    f1 = _softmax(np.stack(feats_1), axis=1)
    f2 = _softmax(np.stack(feats_2), axis=1)
    # torch F.kl_div(log(q), p, 'sum') == sum p * (log p - log q)
    kl = (f2 * (np.log(np.maximum(f2, 1e-30)) - np.log(f1 + eps))).sum() / len(f1)
    return {"kullback_leibler_divergence": float(kl)}
