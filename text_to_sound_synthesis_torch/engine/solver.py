"""Stage-2 training solver: epoch loop, scheduling, EMA, checkpoints, sampling.

Port of ``text_to_sound_synthesis_tpu/engine/solver.py`` (reference
``Solver``, ``Diffsound/sound_synthesis/engine/solver_spec.py:36-596``): lr
policies none / sqrt / linear, the optimizer and scheduler of the config's
first entry, EMA, the OR-ed grad clip, the plateau scheduler stepped every
iteration on the train loss, periodic in-training sampling from the EMA
weights, epoch checkpoints in ping-pong slots with auto-resume, validation
on the EMA weights with the best checkpoints kept, and the per-timestep
accuracy EMAs (``diffusion_acc_list`` / ``diffusion_keep_list``).

One process per card (``torchrun``): the denoiser under DDP when the process
is in a group, each rank on its own shard of the data. Each step's metrics
are read on the host at the start of the next iteration, after that step was
queued, so the host never waits on the step it has just queued: the scheduler
sees a one-step-stale loss, as in the JAX package's loop.
"""

from __future__ import annotations

import math
import os
import signal
import time
from contextlib import contextmanager
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distributed import (all_gather_cat, fold_seed, get_rank, get_world_size,
                                    wrap_ddp)
from ..utils.config import instantiate_from_config
from ..utils.io import write_wav
from .checkpoint import (checkpoint_path, latest_checkpoint, load_checkpoint,
                         restore_train_state, save_checkpoint, train_payload)
from .logger import Logger
from .optimizers import build_optimizer
from .train_state import DiffusionTrainState, make_train_step

__all__ = ["Solver"]


class Solver:
    def __init__(self, config: Mapping[str, Any], model, dataloader: Mapping[str, Any],
                 logger: Logger, *, seed: int = 0):
        """``model``: the port's ``Diffsound`` on its training device (the
        card, or the CPU when the caller put it there). ``dataloader``:
        {'train_loader', 'train_iterations', 'validation_loader' (optional)},
        as ``data.build_dataloader`` returns it. The training generator is
        seeded ``fold_seed(seed + 1, rank)``; validation and sampling draw
        from generators of their own (``_side_generator``)."""
        self.config = dict(config)
        solver_cfg = self.config["solver"]
        self.model = model
        self.device = next(model.parameters()).device
        self.dataloader = dataloader
        self.logger = logger
        self.rank, self.world = get_rank(), get_world_size()
        self.max_epochs = int(solver_cfg["max_epochs"])
        self.save_epochs = int(solver_cfg.get("save_epochs", 30))
        self.validation_epochs = int(solver_cfg.get("validation_epochs", 400))
        self.sample_iterations = solver_cfg.get("sample_iterations", "epoch")
        if self.sample_iterations == "epoch":
            self.sample_iterations = int(dataloader.get("train_iterations", 1))

        # lr policy (solver_spec.py:69-79); the config's batch is per rank
        base_lr = float(solver_cfg.get("base_lr", 3e-6))
        adjust = solver_cfg.get("adjust_lr", "none")
        world_batch = int(self.config.get("dataloader", {}).get("batch_size", 1)) * self.world
        if adjust == "none":
            self.base_lr = base_lr
        elif adjust == "sqrt":
            self.base_lr = base_lr * math.sqrt(world_batch)
        elif adjust == "linear":
            self.base_lr = base_lr * world_batch
        else:
            raise NotImplementedError(f"adjust_lr {adjust!r}")

        # the first optimizer / scheduler entry (the reference's epoch-gated
        # list has one entry in every released config)
        oas = solver_cfg["optimizers_and_schedulers"][0]
        self.op_sc_name = oas.get("name", "none")
        denoiser = model.diffusion.transformer
        optimizer = build_optimizer(oas["optimizer"], denoiser, self.base_lr)
        sched_cfg = oas.get("scheduler")
        if sched_cfg is not None:
            self.scheduler = instantiate_from_config(sched_cfg, base_lr=self.base_lr)
            self.scheduler_step_iteration = int(sched_cfg.get("step_iteration", 1))
        else:
            self.scheduler = None
            self.scheduler_step_iteration = 1
        clip_cfg = solver_cfg.get("clip_grad_norm")
        self.clip_grad = instantiate_from_config(clip_cfg) if clip_cfg else None
        ema_cfg = solver_cfg.get("ema") or {}
        self.ema_decay = float(ema_cfg.get("decay", 0.99))
        self.ema_interval = int(ema_cfg.get("update_interval", 25))

        T = model.diffusion.diffusion_step
        self.state = DiffusionTrainState.create(denoiser, optimizer, T, with_ema=bool(ema_cfg))
        self.ddp = wrap_ddp(denoiser, self.device) if dist.is_initialized() else None
        self.train_step = make_train_step(model, self.clip_grad, self.ema_decay,
                                          self.ema_interval, ddp=self.ddp)
        self.seed = seed
        self.generator = torch.Generator(self.device).manual_seed(fold_seed(seed + 1, self.rank))

        self.last_epoch = -1
        # per-timestep accuracy EMAs (diffusion_transformer.py:221-222, 427-436)
        self.diffusion_acc_list = [0.0] * T
        self.diffusion_keep_list = [0.0] * T
        self._sample_batch = None   # cached captions for in-training sampling
        # a MelGAN for audible samples (the reference ImageLogger's vocoder_cfg)
        self.vocoder = None
        voc_path = solver_cfg.get("vocoder_path")
        if voc_path:
            from ..models.melgan.interface import load_vocoder

            try:
                self.vocoder = load_vocoder(voc_path, device=self.device)
            except (OSError, ValueError, RuntimeError) as e:
                logger.log_info(f"vocoder attach failed ({e!r}); samples stay spec-only")
        # best-checkpoint tracking (PL ModelCheckpoint top-k analogue)
        self.save_top_k = int(solver_cfg.get("save_top_k", 3))
        self._best: list = []   # [(val_loss, name)] ascending

    # -- checkpointing -------------------------------------------------------

    def _payload(self, epoch: int) -> dict:
        states = [self.generator.get_state()]
        if dist.is_initialized() and self.world > 1:
            states = [None] * self.world
            dist.all_gather_object(states, self.generator.get_state())
        return train_payload(
            self.model, self.state, last_epoch=epoch, scheduler=self.scheduler,
            scheduler_name=self.op_sc_name, step_iteration=self.scheduler_step_iteration,
            acc_lists=(self.diffusion_acc_list, self.diffusion_keep_list),
            generator_states=states)

    def save(self, epoch: int, force: bool = False) -> None:
        """``force`` (the end of training, SIGUSR1): ``last`` and the tagged
        ``<epoch>e_<iter>iter``; else the slot ``auto_a`` / ``auto_b`` by the
        epoch's parity, so the newest whole checkpoint is never the one being
        overwritten, and a tagged copy every ``save_epochs`` epochs. Every
        rank takes part (the generators' states are gathered); the primary
        writes."""
        payload = self._payload(epoch)
        if not self.logger.is_primary:
            return
        ckpt, it = self.logger.ckpt_dir, self.state.step
        if force:
            names = ["last", f"{epoch}e_{it}iter"]
        else:
            names = ["auto_a" if epoch % 2 == 0 else "auto_b"]
            if (epoch + 1) % self.save_epochs == 0:
                names.append(f"{epoch}e_{it}iter")
        for name in names:
            save_checkpoint(checkpoint_path(ckpt, name), payload)
        self.logger.log_info(f"saved checkpoint {', '.join(names)} at epoch {epoch}, iter {it}")

    def resume(self, name: Optional[str] = None, path: Optional[str] = None) -> bool:
        """Restore the newest checkpoint of the run (or ``name``, or the file
        ``path``: the port's or the reference's layout). False when there is
        none."""
        if path is None:
            name = name or latest_checkpoint(self.logger.ckpt_dir)
            if name is None:
                return False
            path = checkpoint_path(self.logger.ckpt_dir, name)
        host = restore_train_state(load_checkpoint(path), self.model, self.state,
                                   scheduler=self.scheduler)
        states = host["generator_states"]
        if states is not None and len(states) == self.world:
            self.generator.set_state(states[self.rank])
        elif states is not None:
            self.logger.log_info(f"checkpoint made by {len(states)} ranks, resumed by "
                                 f"{self.world}: the generators start afresh")
        self.last_epoch = host["last_epoch"]
        if host["acc_lists"] is not None:
            self.diffusion_acc_list, self.diffusion_keep_list = host["acc_lists"]
        self.logger.log_info(f"resumed from {path} (epoch {self.last_epoch}, "
                             f"iter {self.state.step})")
        return True

    # -- training ------------------------------------------------------------

    def _host_update_acc(self, t, a0, ak) -> None:
        for i in range(len(t)):
            ti = int(t[i])
            self.diffusion_acc_list[ti] = float(a0[i]) * 0.1 + self.diffusion_acc_list[ti] * 0.9
            self.diffusion_keep_list[ti] = float(ak[i]) * 0.1 + self.diffusion_keep_list[ti] * 0.9

    def _side_generator(self, purpose: int, n: int) -> torch.Generator:
        """A generator for validation (``purpose`` 2, ``n`` the epoch) or
        sampling (3, the iteration), seeded from (seed, purpose, n, rank)
        alone: the training generator's stream never depends on them, so a
        resumed run draws what the uninterrupted one drew."""
        seed = fold_seed(fold_seed(self.seed + purpose, n), self.rank)
        return torch.Generator(self.device).manual_seed(seed)

    @contextmanager
    def _ema_weights(self):
        """The denoiser's parameters hold the EMA for the block (sampling and
        validation use it, as the reference does), restored after."""
        if self.state.ema_params is None:
            yield
            return
        params = [p for _, p in self.state.named_params()]
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            torch._foreach_copy_(params, self.state.ema_params)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, saved)

    def sample(self, suffix: str = "") -> None:
        """In-training sampling: ``top0.85r`` from the cached captions with
        the EMA weights, spec ``.npy`` (+ ``.png`` with PIL, + a 22 050 Hz
        ``.wav`` with the ``vocoder_path`` MelGAN) under ``<run>/samples``
        (solver_spec.py:191-261)."""
        if self._sample_batch is None or not self.logger.is_primary:
            return
        cond_tokens = self._sample_batch["condition_token"][:4]
        with self._ema_weights():
            mel = self.model.generate(self._side_generator(3, self.state.step), cond_tokens,
                                      sample_type="top0.85r")
        spec = ((mel[..., 0].float() + 1.0) / 2.0).cpu().numpy()
        it = self.state.step
        outdir = os.path.join(self.logger.run_dir, "samples")
        os.makedirs(outdir, exist_ok=True)
        for b in range(spec.shape[0]):
            base = os.path.join(outdir, f"it{it}_{b}{suffix}")
            np.save(base + ".npy", spec[b])
            try:
                from PIL import Image
            except ImportError:
                pass
            else:
                img = (np.clip(spec[b], 0, 1) * 255).astype("uint8")[::-1]
                Image.fromarray(img).save(base + ".png")
            if self.vocoder is not None:
                wav = self.vocoder(torch.from_numpy(spec[b:b + 1]))[0].float().cpu().numpy()
                write_wav(base + ".wav", 22050, wav)
        self.logger.log_info(f"wrote {spec.shape[0]} samples at iter {it}")

    def _to_model_batch(self, batch: Mapping[str, Any]) -> dict:
        """Dataset batches carry {'image': mel01 (B, 1, H, W) or (B, H, W, 1)
        in [-1, 1], 'text': [str]} or 'condition_token' (BPE ids, not
        tokenized again). -> tensors on the device, mel NHWC."""
        key = self.model.content_info["key"]
        mel = np.asarray(batch[key], dtype=np.float32)
        if mel.ndim == 4 and mel.shape[1] == 1:    # NCHW -> NHWC
            mel = np.transpose(mel, (0, 2, 3, 1))
        elif mel.ndim == 3:
            mel = mel[..., None]
        if "condition_token" in batch:
            tokens = np.asarray(batch["condition_token"], np.int64)
        else:
            tokens = self.model.text_to_tokens(list(batch[self.model.condition_info["key"]]))["token"]
        return {key: torch.from_numpy(np.ascontiguousarray(mel)).to(self.device),
                "condition_token": torch.as_tensor(tokens, dtype=torch.long).to(self.device)}

    def train_epoch(self, epoch: int, log_frequency: int = 100) -> float:
        """One pass over the train loader; returns the last consumed loss.
        The host reads each step's metrics after queuing the next step (module
        docstring), in one copy, except on logged iterations."""
        loader = self.dataloader["train_loader"]
        if hasattr(loader, "set_epoch"):
            # the shuffle and caption draws follow the TRAINING epoch, so a
            # resumed run does not replay the early epochs' order
            loader.set_epoch(epoch)
        itr_start = time.time()
        last_loss = float("nan")
        pending = None   # (loader index, metrics still on the device)

        def consume(idx, m):
            nonlocal last_loss
            B = m.t.shape[0]
            host = torch.cat([m.loss.reshape(1), m.grad_norm.reshape(1).float(), m.t.float(),
                              m.acc_x0, m.acc_keep]).cpu().numpy()
            last_loss = float(host[0])
            if self.scheduler and idx % self.scheduler_step_iteration == 0:
                self.scheduler.step(last_loss)
            self._host_update_acc(host[2:2 + B], host[2 + B:2 + 2 * B], host[2 + 2 * B:])
            return last_loss, float(host[1])

        for i, batch in enumerate(loader):
            data_time = time.time() - itr_start
            batch = self._to_model_batch(batch)
            if self._sample_batch is None:
                self._sample_batch = batch
            lr = self.scheduler.lr if self.scheduler else self.base_lr
            self.state, metrics = self.train_step(self.state, batch, lr, generator=self.generator)
            if pending is not None:
                consume(*pending)
            pending = (i, metrics)
            it = self.state.step
            if self.sample_iterations and it % max(1, int(self.sample_iterations)) == 0:
                try:
                    self.sample()
                except Exception as e:   # sampling must never stop training
                    self.logger.log_info(f"in-training sampling failed: {e!r}")
            if i % log_frequency == 0:
                loss, gn = consume(*pending)
                pending = None
                self.logger.log_info(
                    f"e{epoch} it{it} loss {loss:.5f} lr {lr:.3e} gnorm {gn:.3f} "
                    f"data_time {data_time:.3f}s iter_time {time.time() - itr_start:.3f}s")
                self.logger.add_scalar("train/loss", loss, it)
                self.logger.add_scalar("train/lr", lr, it)
                self.logger.add_scalar("train/grad_norm", gn, it)
            itr_start = time.time()
        if pending is not None:
            consume(*pending)
        return last_loss

    @torch.no_grad()
    def validate_epoch(self, epoch: int) -> Optional[float]:
        """The mean loss (no auxiliary term, no dropout) over the validation
        loader, uniform t, on the EMA weights; the mean over the ranks."""
        loader = self.dataloader.get("validation_loader")
        if loader is None:
            return None
        key = self.model.content_info["key"]
        T = self.model.diffusion.diffusion_step
        losses = []
        gen = self._side_generator(2, epoch)
        with self._ema_weights():
            for batch in loader:
                b = self._to_model_batch(batch)
                B = b[key].shape[0]
                t = torch.randint(0, T, (B,), generator=gen, device=self.device)
                pt = torch.full((B,), 1.0 / T, device=self.device)
                out = self.model.loss(b[key], b["condition_token"], t, pt, generator=gen,
                                      is_train=False)
                losses.append(out.loss)   # kept on the device: one read at the end
        if not losses:
            return None
        val = torch.stack(losses).mean()
        if dist.is_initialized():
            val = all_gather_cat(val.reshape(1)).mean()
        val = float(val)
        self.logger.log_info(f"validation epoch {epoch}: loss {val:.5f}")
        self.logger.add_scalar("val/loss", val, self.state.step)
        self._maybe_save_best(epoch, val)
        return val

    def _maybe_save_best(self, epoch: int, val_loss: float) -> None:
        """Keep the ``save_top_k`` best checkpoints by validation loss. Every
        rank keeps the list (the loss is the ranks' mean) and takes part in
        the payload; the primary writes and evicts."""
        if self.save_top_k <= 0:
            return
        if len(self._best) >= self.save_top_k and val_loss >= self._best[-1][0]:
            return
        payload = self._payload(epoch)
        name = f"best_e{epoch}_{val_loss:.5f}"
        self._best.append((val_loss, name))
        self._best.sort()
        evicted = [n for _, n in self._best[self.save_top_k:]]
        del self._best[self.save_top_k:]
        if not self.logger.is_primary:
            return
        payload["val_loss"] = val_loss
        save_checkpoint(checkpoint_path(self.logger.ckpt_dir, name), payload)
        for evict in evicted:
            os.remove(checkpoint_path(self.logger.ckpt_dir, evict))
        self.logger.log_info(f"saved best checkpoint {name!r} "
                             f"(top-{self.save_top_k}: {[n for _, n in self._best]})")

    def train(self) -> None:
        """Epochs from the one after ``last_epoch`` to ``max_epochs``: train,
        save (slots), validate every ``validation_epochs``; at the end
        ``last``. SIGUSR1 saves ``last`` at once (the PL stack's preemption
        hook)."""
        def _melk(signum, frame):
            self.logger.log_info("SIGUSR1: checkpointing")
            self.save(self.last_epoch, force=True)

        try:
            signal.signal(signal.SIGUSR1, _melk)
        except ValueError:   # not the main thread
            pass
        for epoch in range(self.last_epoch + 1, self.max_epochs):
            t0 = time.time()
            self.train_epoch(epoch)
            self.logger.log_info(f"epoch {epoch} done in {time.time() - t0:.1f}s")
            self.last_epoch = epoch
            self.save(epoch, force=False)
            if (epoch + 1) % self.validation_epochs == 0:
                self.validate_epoch(epoch)
        self.save(self.max_epochs - 1, force=True)
