"""Stage-2 training: Diffsound's denoiser steps at the configuration's batch, in f32.

Set-up builds Diffsound on the card with seeded weights, the program's
optimizer (``engine/optimizers.py::build_optimizer``: AdamW with the decay
split) and train state, and its step (``engine/train_state.py::make_train_step``
with the configuration's clipping and EMA). It then drives that same state
through the check's first three steps, each on a fresh seeded batch (mels
in [-1, 1] and caption ids) and fresh seeded draws (the timesteps and
``q_sample``'s Gumbel noise, passed as the step's ``draws``), and records
each step's loss, the first gradient as AdamW holds it after step 1 (its
first moment over 1 - beta1) and each leaf's change after step 3. The window
runs more steps the same way; the rate is the samples of every step begun in
the window over the time to a synchronize after the last.

The check makes the reference follow the same three steps from the same
weights, batches and draws, and compares the losses, the gradient and the
change leaf by leaf.
"""

import contextlib
import time

import torch

from .. import reference as ref
from .. import rates, roofline, traffic
from ..reference import codec as rcodec
from ..reference import denoiser as rden
from ..reference import sampler as rsamp
from ..reference import train as rtrain
from ..trace import Phases
from ..weights import materialize, seeded_weights

DRIVER = "Stage2"
CHECK_STEPS = 3
LIMITS = {
    "code_mismatch": 0.01,
    "loss_rel_gap": 3e-6,
    "grad_leaf_gap": 1e-5,
    "change_leaf_gap": 7e-5,
}
DEN = rden.DEN
# what stands in the program's place for the control readings: the reference one
# step lower (the denoiser's f32 with TF32 off in TF32, the encoder's TF32
# convolutions in bf16); and two faults in the reference: half of each batch left
# out, and every seventh code the encoder picks altered
CONTROLS = ("lower_precision", "half_batch", "code_altered")


class Stage2:
    def __init__(self, config: dict, mix: dict, seed: int, device, tracer):
        self.cfg, self.mix, self.seed, self.device, self.tracer = config, mix, seed, device, tracer
        m = config["model"]["params"]
        d = m["diffusion_config"]["params"]
        tp = d["transformer_config"]["params"]
        cp = d["condition_emb_config"]["params"]
        self.dd = m["content_codec_config"]["params"]["ddconfig"]
        self.dims = dict(n_layer=tp["n_layer"], n_head=tp["n_head"],
                         H=int(tp["content_spatial_size"][0]), W=int(tp["content_spatial_size"][1]))
        self.clip = dict(layers=cp.get("layers", 12), heads=cp.get("heads", 8))
        self.T, self.L = d["diffusion_step"], tp["content_seq_len"]
        self.S, self.cond_dim = tp["condition_seq_len"], tp["condition_dim"]
        self.K = m["content_codec_config"]["params"]["n_embed"] + 1
        self.aux = float(d.get("auxiliary_loss_weight", 5e-4))
        self.mask_weight = tuple(float(v) for v in d.get("mask_weight", (1, 1)))
        self.solver = config["solver"]
        data = config["dataloader"]
        self.batch, self.n_mels, self.frames = (data["batch_size"], data["mel_num"],
                                                data["spec_crop_len"])
        self.tok = traffic.tokenizer(config)
        self.lr = float(self.solver["base_lr"])
        self.steps = 0
        self.phases = Phases(device)

    def _model(self):
        from text_to_sound_synthesis_torch.models.diffsound import build_model

        return build_model(self.cfg, device="meta", load_codec=False)

    def _inputs(self, gen):
        """One step's batch and draws, fresh from ``gen``."""
        from text_to_sound_synthesis_torch.engine.train_state import TrainDraws
        from text_to_sound_synthesis_torch.models.diffusion.process import TimestepDraws

        B = self.batch
        mel = traffic.mels(gen, B, self.n_mels, self.frames)
        ids = traffic.caption_ids(gen, B, self.mix["caption_tokens"], **self.tok)
        u = torch.rand((B, self.T), generator=gen, device=self.device)
        uniform = torch.randint(0, self.T, (B,), generator=gen, device=self.device)
        g = rsamp.gumbel_from_uniform(
            torch.rand((B, self.L, self.K), generator=gen, device=self.device))
        draws = TrainDraws(TimestepDraws(rsamp.gumbel_from_uniform(u), uniform), g)
        return {"image": mel, "condition_token": ids}, draws

    def setup(self):
        from text_to_sound_synthesis_torch.engine.clip_grad import ClipGradNorm
        from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer
        from text_to_sound_synthesis_torch.engine.train_state import (DiffusionTrainState,
                                                                       make_train_step)

        with self.phases("weights"):
            model = self._model()
            w = seeded_weights(model, self.seed, self.device)
            self.model = materialize(model, w, self.device).eval()
        with self.phases("operation counts"):
            self.flops = self._count_flops(w)
        del w
        den = self.model.transformer.transformer
        for part in (self.model.content_codec, self.model.transformer.condition_emb):
            part.requires_grad_(False)
        opt = build_optimizer(self.solver["optimizer"], den, self.lr)
        self.state = DiffusionTrainState.create(den, opt, self.T)
        ema = self.solver["ema"]
        self.step_fn = make_train_step(self.model, ClipGradNorm(**self.solver["clip_grad_norm"]),
                                       ema["decay"], ema["update_interval"])
        (self.g_inputs,) = traffic.streams(self.seed, self.device, 1)
        named = self.state.named_params()
        p0 = {n: p.detach().clone() for n, p in named}
        losses, codes = [], []
        encode = self.model.encode_content

        def recording(mel):                     # the check steps' codes, as the program chose them
            out = encode(mel)
            codes.append(out.clone())
            return out

        self.model.encode_content = recording
        for k in range(CHECK_STEPS):
            if k == 1:
                t_first = time.perf_counter()
            batch, draws = self._inputs(self.g_inputs)
            _, metrics = self.step_fn(self.state, batch, self.lr, draws=draws)
            losses.append(metrics.loss)
            if k == 0:
                b1 = opt.defaults["betas"][0]
                grad = {n: float(opt.state[p]["exp_avg"].norm()) / (1 - b1) for n, p in named}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases.append(("check steps 2-3", time.perf_counter() - t_first))
        del self.model.encode_content           # the window runs the method itself
        self.seen = {"loss": [float(v) for v in losses], "grad": grad, "codes": codes,
                     "change": {n: float((p.detach() - p0[n]).norm()) for n, p in named}}
        del p0

    def _count_flops(self, w) -> dict:
        """Operations of one step: the denoiser forward and backward (three
        forwards' operations) in f32, the text tower forward in f32 and the
        codec's encoder forward in TF32."""
        meta = roofline.meta_like(w)
        B = self.batch
        toks = torch.zeros((B, self.L), dtype=torch.long, device="meta")
        t = torch.zeros((B,), dtype=torch.long, device="meta")
        cond = torch.zeros((B, self.S, self.cond_dim), device="meta")
        den = roofline.counted_flops(lambda: rden.head_logits(
            meta, rden.denoiser(meta, toks, t, cond, **self.dims)))
        text = roofline.counted_flops(rden.clip_text, meta,
                                      torch.zeros((B, self.S), dtype=torch.long, device="meta"),
                                      **self.clip)
        mel = torch.zeros((B, 1, self.n_mels, self.frames), device="meta")
        enc = roofline.counted_flops(rcodec.encoder, meta, mel, self.dd)
        return {"f32": 3 * den + text, "tf32": enc}

    def run_window(self, seconds: float) -> dict:
        events = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            if len(events) >= 2:
                events[-2].synchronize()       # keep at most two steps queued
            with self.tracer.span("step"):
                batch, draws = self._inputs(self.g_inputs)
                self.step_fn(self.state, batch, self.lr, draws=draws)
            ev = torch.cuda.Event() if self.device.type == "cuda" else None
            if ev is not None:
                ev.record()
                events.append(ev)
            self.steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        return {"train_samples_per_s": rates.steps_rate(self.steps, self.batch, start, end)}

    def work(self) -> dict:
        return dict(steps=self.steps, samples=self.steps * self.batch, stage2_step_ops=self.flops)

    def attempted(self):
        return self.steps, 0

    def release(self):
        del self.model, self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> dict:
        """{name: value} of the numbers compared. The frozen codec's encoder
        runs cuDNN's TF32 convolutions, whose nearest-code choices part from
        float32's at near-ties; so the encoder's codes are held to the
        reference's by themselves (``code_mismatch``), and the reference's
        three steps follow from the codes the program's encoder chose.
        ``control``: "lower_precision" puts the reference one step lower in
        the program's place (the encoder in bf16, the denoiser's steps in
        TF32); "half_batch" the reference with the loss over the first half
        of each batch; "code_altered" the reference with every seventh code
        its encoder picks moved to the next code."""
        model = self._model()
        w = seeded_weights(model, self.seed, self.device)
        del model
        ref_codes = self._codes(w, None)
        if control is None:
            seen = self.seen
        else:
            codes = self._codes(w, control)
            seen = dict(self._reference(w, codes, control), codes=codes)
        # where the program's codes do not cover the batch, there is no state to follow
        follow = [c if c.shape == r.shape else r for c, r in zip(seen["codes"], ref_codes)]
        refd = self._reference(w, follow, None)
        grad_floor = 1e-3 * torch.tensor(list(refd["grad"].values())).median().item()
        kept = lambda n: refd["grad"][n] >= grad_floor
        self.worst = {k: max(rtrain.leaf_gaps(seen[k], refd[k], keep).items(), key=lambda kv: kv[1])
                      for k, keep in (("grad", None), ("change", kept))}
        mismatch = [float((a.long() != b).float().mean()) if a.shape == b.shape else 1.0
                    for a, b in zip(seen["codes"], ref_codes)]
        return {
            "code_mismatch": max(mismatch),
            "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(seen["loss"], refd["loss"])),
            "grad_leaf_gap": rtrain.leaf_gap(seen["grad"], refd["grad"]),
            "change_leaf_gap": rtrain.leaf_gap(seen["change"], refd["change"],
                                               keep=lambda n: refd["grad"][n] >= grad_floor),
        }

    def _codes(self, w, variant):
        """The reference encoder's codes of the three check batches (in bf16
        for the lower-precision control)."""
        (gen,) = traffic.streams(self.seed, self.device, 1)
        low = (torch.autocast(self.device.type, dtype=torch.bfloat16)
               if variant == "lower_precision" else contextlib.nullcontext())
        out = []
        with torch.no_grad(), ref.full_f32(), low:
            for _ in range(CHECK_STEPS):
                batch, _ = self._inputs(gen)
                mel = batch["image"]
                if variant == "half_batch":
                    mel = mel[: self.batch // 2]
                codes = rcodec.encode_tokens(w, mel.permute(0, 3, 1, 2), self.dd)
                if variant == "code_altered":
                    n_e = w[rcodec.CODEC + "quantize.embedding.weight"].shape[0]
                    codes[:, ::7] = (codes[:, ::7] + 1) % n_e
                out.append(codes)
        return out

    def _reference(self, w, codes, variant):
        """The reference's three steps from the seeded weights on the batches'
        ``codes``: losses, the first clipped gradient's and each leaf's change
        norms by the program's parameter names."""
        (gen,) = traffic.streams(self.seed, self.device, 1)
        params = {n: w[n].clone().requires_grad_(True) for n in w if n.startswith(DEN)}
        p0 = {n: p.detach().clone() for n, p in params.items()}
        frozen = {n: v for n, v in w.items() if not n.startswith(DEN)}
        opt = rtrain.AdamW(params, betas=tuple(self.solver["optimizer"]["params"]["betas"]),
                           weight_decay=self.solver["optimizer"]["params"]["weight_decay"])
        sch = rsamp.schedule(self.T, self.K, self.device)
        losses, grad = [], None
        mode = ref.tf32() if variant == "lower_precision" else ref.full_f32()
        with mode:
            for k in range(CHECK_STEPS):
                batch, draws = self._inputs(gen)
                ids, g = batch["condition_token"], draws.gumbel
                t = draws.timesteps.uniform.long()
                x0 = codes[k].long()
                if x0.shape[0] != ids.shape[0]:          # a half batch
                    ids, g, t = ids[:x0.shape[0]], g[:x0.shape[0]], t[:x0.shape[0]]
                pt = torch.full(t.shape, 1.0 / self.T, device=self.device)
                with torch.no_grad():
                    cond = rden.clip_text(w, ids, **self.clip)
                loss = rtrain.diffusion_loss({**frozen, **params}, x0, cond, t, pt, g, sch,
                                             dims=self.dims, aux_weight=self.aux,
                                             mask_weight=self.mask_weight)
                grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
                grads = rtrain.clip_global(grads, self.solver["clip_grad_norm"]["max_norm"])
                if k == 0:
                    grad = {n[len(DEN):]: float(g_.norm()) for n, g_ in grads.items()}
                opt.step(grads, self.lr)
                losses.append(float(loss.detach()))
        change = {n[len(DEN):]: float((p.detach() - p0[n]).norm()) for n, p in params.items()}
        return {"loss": losses, "grad": grad, "change": change}
