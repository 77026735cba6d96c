"""Stage-2 checkpoints in the reference's single-file ``torch.save`` layout.

Port of ``text_to_sound_synthesis_tpu/engine/checkpoint.py``, whose target is
the reference solver's file (``solver_spec.py:336-447``)::

    {"last_epoch", "last_iter",
     "model": the whole composite's state dict (content_codec.*,
              transformer.condition_emb.*, transformer.transformer.*) plus the
              timestep sampler's buffers transformer.Lt_history / Lt_count,
     "ema": the EMA of the denoiser, named relative to the diffusion module
            (transformer.*),
     "optimizer_and_scheduler": {name: {"optimizer": {"module": state_dict},
                                        "scheduler": {"module": state_dict,
                                                      "step_iteration": n}}}}

and beside them the port's ``diffusion_acc_list`` / ``diffusion_keep_list``
(the reference keeps those lists on its module) and ``generator``, the
training generators' states, one a rank, so that a resumed run continues the
interrupted one bit for bit.

A reference file resumes with no converter: the schedule buffers it keeps
on its diffusion module (``transformer.log_at`` ...), which the port computes,
and the EMA's copy of the frozen text tower (``condition_emb.*``) are read
past; any other key that does not fit raises. Its optimizer state loads by
position (``optimizers.param_groups`` builds the reference's two groups in
its order), and with it, as ``torch.optim`` does, its hyper-parameters.

Names, as the JAX package's: ``last``, the ping-pong slots ``auto_a`` /
``auto_b`` and ``<epoch>e_<iter>iter``, each ``<name>.pth``. Every write goes
to a temporary file that ``os.replace`` puts in place, so a name always holds
a whole checkpoint. Files are unpickled whole: load only checkpoints you trust.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from ..models.diffusion.process import TimestepSamplerState

__all__ = ["checkpoint_path", "save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "train_payload", "restore_train_state", "load_weights"]

#: buffers the reference registers on its diffusion module, computed by the port
_SCHEDULE_BUFFERS = tuple(f"transformer.{n}" for n in (
    "log_at", "log_bt", "log_ct", "log_1_min_ct", "log_cumprod_at", "log_cumprod_bt",
    "log_cumprod_ct", "log_1_min_cumprod_ct"))
_MUTABLE = ("last", "auto_a", "auto_b")


def checkpoint_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, name + ".pth")


def save_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    """``torch.save`` to a temporary file beside ``path``, then ``os.replace``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checkpoint(path: str, map_location: Any = "cpu", *, mmap: bool = False) -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=False, mmap=mmap)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The name of the checkpoint in ``ckpt_dir`` with the highest stored
    ``last_iter`` (read through a memory map, no tensor loaded), among
    ``last``, ``auto_a``, ``auto_b`` and ``*iter``; ``last`` wins a tie."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = []
    for f in os.listdir(ckpt_dir):
        name, ext = os.path.splitext(f)
        if ext != ".pth" or not (name in _MUTABLE or name.endswith("iter")):
            continue
        it = int(load_checkpoint(os.path.join(ckpt_dir, f), mmap=True).get("last_iter", -1))
        cands.append((it, name == "last", name))
    return max(cands)[2] if cands else None


def train_payload(model, state, *, last_epoch: int, scheduler=None, scheduler_name: str = "none",
                  step_iteration: int = 1, acc_lists=None,
                  generator_states: Optional[List[torch.Tensor]] = None) -> Dict[str, Any]:
    """The checkpoint of a training run (module docstring). ``model`` is the
    port's ``Diffsound``, ``state`` its ``DiffusionTrainState``."""
    model_sd = dict(model.state_dict())
    model_sd["transformer.Lt_history"] = state.lt.Lt_history
    model_sd["transformer.Lt_count"] = state.lt.Lt_count
    payload = {"last_epoch": int(last_epoch), "last_iter": int(state.step), "model": model_sd}
    if state.ema_params is not None:
        payload["ema"] = {f"transformer.{n}": e
                          for (n, _), e in zip(state.named_params(), state.ema_params)}
    op_sc = {"optimizer": {"module": state.optimizer.state_dict(), "step_iteration": 1}}
    if scheduler is not None:
        op_sc["scheduler"] = {"module": scheduler.state_dict(), "step_iteration": step_iteration}
    payload["optimizer_and_scheduler"] = {scheduler_name: op_sc}
    if acc_lists is not None:
        payload["diffusion_acc_list"], payload["diffusion_keep_list"] = (list(a) for a in acc_lists)
    if generator_states is not None:
        payload["generator"] = list(generator_states)
    return payload


def _model_state(payload: Dict[str, Any]):
    """The payload's model state dict without the reference's buffers, and
    its timestep buffers (Lt_history, Lt_count; None where absent)."""
    sd = {k: v for k, v in payload["model"].items() if isinstance(v, torch.Tensor)}
    hist, count = sd.pop("transformer.Lt_history", None), sd.pop("transformer.Lt_count", None)
    for k in _SCHEDULE_BUFFERS:
        sd.pop(k, None)
    return sd, hist, count


def load_weights(model, payload: Dict[str, Any], *, prefer_ema: bool = True) -> None:
    """Warm start: the composite's weights from ``payload`` (either layout),
    the denoiser's from its EMA where the file has one and ``prefer_ema``
    (the JAX tool's ``convert_diffsound_checkpoint``); nothing else."""
    sd, _, _ = _model_state(payload)
    ema = payload.get("ema") or {}
    if prefer_ema and ema:
        for k, v in ema.items():
            if k.startswith("transformer.") and f"transformer.{k}" in sd:
                sd[f"transformer.{k}"] = v
    model.load_state_dict(sd)


def restore_train_state(payload: Dict[str, Any], model, state, *,
                        scheduler=None) -> Dict[str, Any]:
    """Load ``payload`` (the port's or the reference's layout) into ``model``,
    ``state`` and ``scheduler`` in place. Returns the host's part:
    ``last_epoch``, ``last_iter``, ``acc_lists`` and ``generator_states``
    (None where the file has none)."""
    sd, hist, count = _model_state(payload)
    model.load_state_dict(sd)
    dev = state.lt.Lt_history.device
    if hist is not None and count is not None:
        state.lt = TimestepSamplerState(hist.to(dev, torch.float32).clone(),
                                        count.to(dev, torch.float32).clone())
    if state.ema_params is not None:
        ema = payload.get("ema") or {}
        with torch.no_grad():
            for (n, p), e in zip(state.named_params(), state.ema_params):
                e.copy_(ema[f"transformer.{n}"] if ema else p)
    op_sc = payload.get("optimizer_and_scheduler") or {}
    if op_sc:
        entry = next(iter(op_sc.values()))
        state.optimizer.load_state_dict(entry["optimizer"]["module"])
        if scheduler is not None and "scheduler" in entry:
            sched_sd = entry["scheduler"]["module"]
            scheduler.load_state_dict(sched_sd)
            if "lr" not in sched_sd:       # the reference keeps the rate on the optimizer
                scheduler.lr = state.optimizer.param_groups[0]["lr"]
    state.step = int(payload.get("last_iter", 0))
    acc = None
    if "diffusion_acc_list" in payload:
        acc = [list(payload["diffusion_acc_list"]), list(payload["diffusion_keep_list"])]
    return {"last_epoch": int(payload.get("last_epoch", -1)), "last_iter": state.step,
            "acc_lists": acc, "generator_states": payload.get("generator")}
