"""Supervised mel-classifier training: the engine of VGGishish and Melception
(PyTorch port).

Port of ``text_to_sound_synthesis_tpu/engine/classifier_solver.py``. Parity
targets: the standalone trainers of the perceptual and evaluation networks
(``Codebook/specvqgan/modules/losses/vggishish/train_vggishish.py``,
``train_melception.py``, ``loss.py`` WeightedCrossEntropy, ``metrics.py``
accuracy@k / mAP / d-prime).

The step trains every parameter with AdamW (the JAX package's
``optax.adamw`` there has no decay mask). Its forward runs the model in
train mode, where a flax-style BatchNorm (``VGGishish(use_bn=True)``)
normalises with the batch's statistics and updates its running ones; the
port's ``Melception`` keeps its BatchNorms, the JAX package's folded
affine, in eval mode in train mode too (``Melception.train``). The metrics
are a numpy copy of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["weighted_cross_entropy", "classification_metrics", "ClassifierTrainState",
           "make_classifier_train_step", "logits_of"]


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(w_y ce) / sum(w_y), the reference's WeightedCrossEntropy
    (loss.py); the plain mean without ``weights``. The logits go to f32."""
    ce = nn.functional.cross_entropy(logits.float(), targets.long(), reduction="none")
    if weights is None:
        return ce.mean()
    w = weights[targets.long()]
    return (ce * w).sum() / w.sum()


def classification_metrics(targets: np.ndarray, logits: np.ndarray,
                           topk=(1, 5)) -> Dict[str, float]:
    """accuracy@k, mAP, mean ROC-AUC, d-prime (metrics.py:10-60)."""
    out: Dict[str, float] = {}
    order = np.argsort(-logits, axis=1)
    for k in topk:
        hit = (order[:, :k] == targets[:, None]).any(axis=1)
        out[f"accuracy_{k}"] = float(hit.mean())

    num_cls = logits.shape[1]
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    onehot = np.eye(num_cls)[targets]

    aps, aucs = [], []
    for c in range(num_cls):
        y, s = onehot[:, c], probs[:, c]
        if y.sum() == 0 or y.sum() == len(y):
            continue
        aps.append(_average_precision(y, s))
        aucs.append(_roc_auc(y, s))
    if aps:
        out["mAP"] = float(np.mean(aps))
    if aucs:
        mauc = float(np.mean(aucs))
        out["mROCAUC"] = mauc
        from scipy.stats import norm

        out["dprime"] = float(norm.ppf(np.clip(mauc, 1e-6, 1 - 1e-6)) * np.sqrt(2))
    return out


def _average_precision(y: np.ndarray, scores: np.ndarray) -> float:
    order = np.argsort(-scores)
    y = y[order]
    cum_pos = np.cumsum(y)
    precision = cum_pos / np.arange(1, len(y) + 1)
    return float((precision * y).sum() / max(y.sum(), 1))


def _roc_auc(y: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney with average ranks for ties (sklearn's semantics)."""
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    s = scores[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2 + 1
        i = j + 1
    n_pos, n_neg = y.sum(), (1 - y).sum()
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def logits_of(out) -> torch.Tensor:
    """A classifier's logits: Melception returns a feature dict, VGGishish the logits."""
    return out["logits"] if isinstance(out, dict) else out


@dataclass
class ClassifierTrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, lr: float, weight_decay: float = 1e-4):
        """AdamW (optax's defaults: betas 0.9 / 0.999, eps 1e-8) over every parameter."""
        return cls(model, torch.optim.AdamW(model.parameters(), lr=lr,
                                            weight_decay=weight_decay))


def make_classifier_train_step(class_weights: Optional[torch.Tensor] = None) -> Callable:
    """``step(state, mel, target) -> metrics``: the weighted cross entropy of
    the model's logits in train mode, its gradients and the AdamW update,
    in place; ``metrics`` holds the loss and the batch's accuracy, detached
    on the device."""

    def step(state: ClassifierTrainState, mel: torch.Tensor, target: torch.Tensor):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = logits_of(state.model(mel))
        loss = weighted_cross_entropy(logits, target, class_weights)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        acc = (logits.argmax(-1) == target).float().mean()
        return {"loss": loss.detach(), "accuracy": acc.detach()}

    return step
