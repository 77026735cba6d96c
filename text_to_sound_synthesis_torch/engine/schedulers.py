"""Learning-rate schedules as host-side state machines.

A copy of ``text_to_sound_synthesis_tpu/engine/schedulers.py`` (the port never
imports the JAX package); parity targets ``ReduceLROnPlateauWithWarmup`` and
``CosineAnnealingLRWithWarmup``
(``Diffsound/sound_synthesis/engine/lr_scheduler.py:14-295``). Each scheduler
owns a scalar ``lr`` that the train step sets on the optimizer's groups before
its update; the plateau logic reads the per-iteration loss on the host.

Both schedulers ``step()`` every iteration (solver config ``step_iteration: 1``).
``load_state_dict`` also reads the reference scheduler's own state (its
``num_bad_epochs``), so a reference checkpoint resumes; keys the port does not
keep are ignored.
"""

from __future__ import annotations

import math
from typing import Optional

from ..utils.config import register

__all__ = ["ReduceLROnPlateauWithWarmup", "CosineAnnealingLRWithWarmup"]


@register(
    "text_to_sound_synthesis_tpu.engine.ReduceLROnPlateauWithWarmup",
    "sound_synthesis.engine.lr_scheduler.ReduceLROnPlateauWithWarmup",
)
class ReduceLROnPlateauWithWarmup:
    """Linear warmup from the base lr to ``warmup_lr`` over ``warmup`` steps,
    then reduce-on-plateau with patience/threshold/cooldown semantics."""

    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
        eps: float = 1e-8,
        warmup_lr: Optional[float] = None,
        warmup: int = 0,
        step_iteration: int = 1,  # accepted for config parity (solver handles it)
    ):
        if factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        if mode not in ("min", "max"):
            raise ValueError(f"unknown mode {mode!r}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"unknown threshold_mode {threshold_mode!r}")
        self.lr = float(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.warmup = warmup
        self.warmup_lr = warmup_lr
        self.step_iteration = step_iteration

        self.last_epoch = 0
        self.cooldown_counter = 0
        self.num_bad = 0
        self.best = math.inf if mode == "min" else -math.inf
        if warmup_lr is not None and warmup > 0:
            self.warmup_step = max(0.0, (warmup_lr - self.lr) / float(warmup))
        else:
            self.warmup_step = 0.0

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> float:
        """Advance one iteration with the observed metric; returns the new lr."""
        self.last_epoch += 1
        if self.last_epoch <= self.warmup:
            self.lr = max(self.lr + self.warmup_step, self.min_lr)
            return self.lr

        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad = 0
        else:
            self.num_bad += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0

        if self.num_bad > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    _STATE = ("lr", "last_epoch", "cooldown_counter", "num_bad", "best")

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._STATE}

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        if "num_bad_epochs" in state:                 # the reference's name
            state.setdefault("num_bad", state["num_bad_epochs"])
        for k in self._STATE:
            if k in state:
                setattr(self, k, state[k])


@register(
    "text_to_sound_synthesis_tpu.engine.CosineAnnealingLRWithWarmup",
    "sound_synthesis.engine.lr_scheduler.CosineAnnealingLRWithWarmup",
)
class CosineAnnealingLRWithWarmup:
    """Linear warmup then cosine decay from the peak reached during warmup
    (lr_scheduler.py:213-295; note the reference anneals from ``max_lr`` tracked
    during warmup, floored at ``min_lr``)."""

    def __init__(
        self,
        base_lr: float,
        T_max: int,
        min_lr: float = 0.0,
        warmup_lr: Optional[float] = None,
        warmup: int = 0,
        step_iteration: int = 1,
    ):
        self.lr = float(base_lr)
        self.T_max = T_max
        self.min_lr = min_lr
        self.warmup = warmup
        self.warmup_lr = warmup_lr
        self.step_iteration = step_iteration
        self.last_epoch = 0
        self.max_lr = min_lr
        if warmup_lr is not None and warmup > 0:
            self.warmup_step = max(0.0, (warmup_lr - self.lr) / float(warmup))
        else:
            self.warmup_step = 0.0

    def step(self, metric: float | None = None) -> float:
        self.last_epoch += 1
        if self.last_epoch <= self.warmup:
            self.lr = self.lr + self.warmup_step
            self.max_lr = max(self.max_lr, self.lr)
        else:
            progress = (self.last_epoch - self.warmup) / max(1, self.T_max - self.warmup)
            factor = max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
            self.lr = max(self.max_lr * factor, self.min_lr)
        return self.lr

    _STATE = ("lr", "last_epoch", "max_lr")

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._STATE}

    def load_state_dict(self, state: dict) -> None:
        for k in self._STATE:
            if k in state:
                setattr(self, k, state[k])
