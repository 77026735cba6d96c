"""Stage-1 training: SpecVQGAN's codec with LPAPS and the PatchGAN, both phases a step.

Set-up builds the codec, the PatchGAN and a frozen LPAPS (seeded VGG16
convolutions, heads of ones, no standardisation) on the card with seeded
weights (the codebook U(-1/n, 1/n), as a training run starts), the program's
train state and step (``engine/vqgan_solver.py``: ``VQGANTrainState.create``,
``make_vqgan_train_step`` with the configuration's loss), and sets the step
count to ``disc_start`` so that the adversarial terms count. It drives that
state through the check's first three steps on fresh seeded mels, recording
both phases' losses, each optimizer's first gradient (its first moment over
1 - beta1 after step 1) and every leaf's change after step 3; the window runs
more steps the same way. The batch, the mel shape, the learning rate and
Adam's betas are the configuration's.
"""

import contextlib
import math
import time

import torch
from torch import nn

from .. import reference as ref
from .. import rates, roofline, traffic
from ..reference import stage1 as rs1
from ..reference import train as rtrain
from ..trace import Phases
from ..weights import seeded_weights

DRIVER = "Stage1"
CHECK_STEPS = 3
LIMITS = {
    "code_mismatch": 0.01,
    "grad_cos_gap": 0.01,
    "loss_rel_gap": 0.018,
    "change_leaf_gap": 0.18,
}


# what stands in the program's place for the control readings: the reference
# computed in bf16 (the program's own f32 runs cuDNN's TF32 convolutions, so the
# next step down is bf16); and two faults in the reference: half of each batch
# left out of both phases' losses (the codes still of the whole batch), and
# every seventh code the quantizer picks altered
CONTROLS = ("bf16", "half_batch", "code_altered")


def _cos_gap(prog: dict, ref: dict, part: str) -> float:
    """1 - the cosine between two gradients over the codec's (or the
    PatchGAN's) leaves, in float64."""
    dot = nprog = nref = 0.0
    for n, r in ref.items():
        if n.startswith("disc.") != (part == "disc"):
            continue
        if n not in prog or prog[n].shape != r.shape:
            return 1.0
        a, b = prog[n].to(r.device, torch.float64), r.double()
        dot, nprog, nref = (dot + float((a * b).sum()), nprog + float(a.square().sum()),
                            nref + float(b.square().sum()))
    return 1.0 - dot / math.sqrt(max(nprog * nref, 1e-300))


class Stage1:
    def __init__(self, config: dict, mix: dict, seed: int, device, tracer):
        self.cfg, self.mix, self.seed, self.device, self.tracer = config, mix, seed, device, tracer
        mp = config["model"]["params"]
        self.dd = mp["ddconfig"]
        lp = mp["lossconfig"]["params"]
        self.loss = dict(perceptual_weight=lp["perceptual_weight"], disc_weight=lp["disc_weight"],
                         codebook_weight=lp["codebook_weight"])
        self.disc_start = lp["disc_start"]
        data = config["dataloader"]
        self.batch, self.n_mels, self.frames = (data["batch_size"], data["mel_num"],
                                                data["spec_crop_len"])
        self.lr = config["model"]["base_learning_rate"] * self.batch
        self.betas = tuple(config["optimizer"]["betas"])
        self.steps = 0
        self.phases = Phases(device)

    def _modules(self):
        from text_to_sound_synthesis_torch.models.discriminator import NLayerDiscriminator
        from text_to_sound_synthesis_torch.models.lpaps import LPAPS
        from text_to_sound_synthesis_torch.models.vqgan.model import VQModel

        mp = self.cfg["model"]["params"]
        with torch.device("meta"):
            codec = VQModel(mp["ddconfig"], n_embed=mp["n_embed"], embed_dim=mp["embed_dim"])
            disc = NLayerDiscriminator(mp["lossconfig"]["params"]["disc_in_channels"])
            lpaps = LPAPS(n_mels=self.n_mels)
        return codec, disc, lpaps

    def _weights(self):
        """{name: tensor}: the codec's names as they are, ``disc.`` and ``lpaps.``
        before the others'."""
        codec, disc, lpaps = self._modules()
        w = seeded_weights(codec, self.seed, self.device)
        n_e = w["quantize.embedding.weight"].shape[0]
        g = torch.Generator(self.device).manual_seed(self.seed + 3)
        w["quantize.embedding.weight"] = (torch.rand(w["quantize.embedding.weight"].shape,
                                                     generator=g, device=self.device) * 2 - 1) / n_e
        w.update({"disc." + k: v for k, v in seeded_weights(disc, self.seed + 1,
                                                             self.device).items()})
        lw = seeded_weights(lpaps, self.seed + 2, self.device)
        for k in lw:
            if k.startswith("lin"):
                lw[k] = torch.ones_like(lw[k])
        w.update({"lpaps." + k: v for k, v in lw.items()})
        w["lpaps.scaling_layer.shift"] = torch.zeros(self.n_mels, device=self.device)
        w["lpaps.scaling_layer.scale"] = torch.ones(self.n_mels, device=self.device)
        return (codec, disc, lpaps), w

    def _mel(self, gen):
        return traffic.mels(gen, self.batch, self.n_mels, self.frames, self.mix["loudness"])

    def setup(self):
        from text_to_sound_synthesis_torch.engine.vqgan_solver import (VQGANTrainState,
                                                                        loss_config,
                                                                        make_vqgan_train_step)

        with self.phases("weights"):
            (codec, disc, lpaps), w = self._weights()
        with self.phases("operation counts"):
            self.flops = self._count_flops(w)

        def load(module, prefix):
            module = module.to_empty(device=self.device)
            sd = {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}
            if prefix == "":
                sd = {k: v for k, v in sd.items() if not k.startswith(("disc.", "lpaps."))}
            missing, unexpected = module.load_state_dict(sd, strict=False)
            if unexpected or any("running" not in k and "num_batches" not in k for k in missing):
                raise RuntimeError(f"weights do not fit: {missing} {unexpected}")
            for m in module.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.reset_running_stats()
            return module

        codec, disc, lpaps = load(codec, ""), load(disc, "disc."), load(lpaps, "lpaps.")
        del w
        lpaps.requires_grad_(False)
        cfg = loss_config(self.cfg["model"]["params"]["lossconfig"]["params"])
        self.state = VQGANTrainState.create(codec, disc, self.lr, self.betas)
        self.state.step = self.disc_start
        self.step_fn = make_vqgan_train_step(lpaps, cfg)
        (self.g_inputs,) = traffic.streams(self.seed, self.device, 1)
        named = [(n, p) for n, p in codec.named_parameters()] + \
                [("disc." + n, p) for n, p in disc.named_parameters()]
        p0 = {n: p.detach().clone() for n, p in named}
        losses = []
        for k in range(CHECK_STEPS):
            _, metrics = self.step_fn(self.state, self._mel(self.g_inputs), self.lr)
            losses += [metrics["total_loss"], metrics["disc_loss"]]
            if k == 0:
                codes = metrics["indices"].clone()   # the quantizer's codes of the first batch
                b1 = self.betas[0]
                grad, gvec = {}, {}
                for opt, prefix, mod in ((self.state.ae_opt, "", codec),
                                         (self.state.disc_opt, "disc.", disc)):
                    for n, p in mod.named_parameters():
                        g = opt.state[p]["exp_avg"] / (1 - b1)
                        grad[prefix + n] = float(g.norm())
                        gvec[prefix + n] = g.cpu()     # kept off the card for the check
        self.seen = {"loss": [float(v) for v in losses], "grad": grad, "gvec": gvec,
                     "codes": codes,
                     "change": {n: float((p.detach() - p0[n]).norm()) for n, p in named}}
        del p0

    def _count_flops(self, w) -> dict:
        """Operations of one step in TF32: the codec's forward and backward
        (three forwards), LPAPS on both inputs with the gradient to the
        reconstruction (twice its forward on one input, plus the forward on the
        other), the PatchGAN's forward and backward on the reconstruction, the
        fresh codec forward and the PatchGAN's forward and backward on the real
        and the fresh batch."""
        meta = roofline.meta_like(w)
        mel = torch.zeros((self.batch, 1, self.n_mels, self.frames), device="meta")
        codec = roofline.counted_flops(rs1.codec_forward, meta, mel, self.dd)
        lp = roofline.counted_flops(rs1.lpaps, meta, mel, mel) / 2
        disc = roofline.counted_flops(rs1.patchgan, meta, mel)
        return {"tf32": 3 * codec + 3 * lp + 3 * disc + codec + 2 * 3 * disc}

    def run_window(self, seconds: float) -> dict:
        events = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            if len(events) >= 2:
                events[-2].synchronize()       # keep at most two steps queued
            with self.tracer.span("step"):
                self.step_fn(self.state, self._mel(self.g_inputs), self.lr)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
            self.steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        return {"stage1_samples_per_s": rates.steps_rate(self.steps, self.batch, start, end)}

    def work(self) -> dict:
        return dict(steps=self.steps, samples=self.steps * self.batch, stage1_step_ops=self.flops)

    def attempted(self):
        return self.steps, 0

    def release(self):
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> dict:
        """{name: value} of the numbers compared. ``control``: "bf16" puts the
        reference computed in bf16 (autocast) in the program's place;
        "half_batch" the reference with each phase's loss over the first half
        of each batch (its codes of the whole batch); "code_altered" the
        reference with every seventh code its quantizer picks moved to the
        next code."""
        _, w = self._weights()
        seen = self.seen if control is None else self._reference(w, control)
        refd = self._reference(w, None)
        grad_floor = 1e-3 * torch.tensor(list(refd["grad"].values())).median().item()
        kept = lambda n: refd["grad"][n] >= grad_floor
        self.worst = {k: max(rtrain.leaf_gaps(seen[k], refd[k], keep).items(), key=lambda kv: kv[1])
                      for k, keep in (("grad", None), ("change", kept))}
        # The first gradient's norms are not compared: no control or fault parts
        # them from TF32 sound runs by the margins the limits need (PERF.md gives
        # the readings); its direction is.
        codes = seen["codes"]
        self.detail = {"loss_gaps": [abs(a - b) / abs(b)
                                     for a, b in zip(seen["loss"], refd["loss"])],
                       "grad_cos_gaps": {part: _cos_gap(seen["gvec"], refd["gvec"], part)
                                         for part in ("codec", "disc")}}
        return {
            "code_mismatch": (float((codes.long() != refd["codes"]).float().mean())
                              if codes.shape == refd["codes"].shape else 1.0),
            # the first gradient's direction: half of the batch left out of the
            # losses turns it, where the norms and the losses barely move
            "grad_cos_gap": max(self.detail["grad_cos_gaps"].values()),
            "loss_rel_gap": max(self.detail["loss_gaps"]),
            "change_leaf_gap": rtrain.leaf_gap(seen["change"], refd["change"],
                                               keep=lambda n: refd["grad"][n] >= grad_floor),
        }

    def _reference(self, w, variant):
        (gen,) = traffic.streams(self.seed, self.device, 1)
        train = {n: v.clone().requires_grad_(True) for n, v in w.items()
                 if not n.startswith("lpaps.")}
        codec_p = {n: v for n, v in train.items() if not n.startswith("disc.")}
        disc_p = {n: v for n, v in train.items() if n.startswith("disc.")}
        frozen = {n: v for n, v in w.items() if n.startswith("lpaps.")}
        p0 = {n: v.detach().clone() for n, v in train.items()}
        opts = [rtrain.AdamW(ps, betas=self.betas, weight_decay=0.0) for ps in (codec_p, disc_p)]
        losses, grad, gvec, codes = [], {}, {}, None
        low = (torch.autocast(self.device.type, dtype=torch.bfloat16) if variant == "bf16"
               else contextlib.nullcontext())
        with ref.full_f32(), low:
            for k in range(CHECK_STEPS):
                mel = self._mel(gen).permute(0, 3, 1, 2)
                if k == 0:
                    with torch.no_grad():
                        codes = rs1.codes(w, mel, self.dd, variant == "code_altered")
                if variant == "half_batch":
                    mel = mel[: self.batch // 2]
                for phase, (ps, opt) in enumerate(zip((codec_p, disc_p), opts)):
                    allw = {**frozen, **codec_p, **disc_p}
                    alter = variant == "code_altered"
                    loss = (rs1.ae_loss(allw, mel, self.dd, self.loss, alter) if phase == 0
                            else rs1.d_loss(allw, mel, self.dd, alter))
                    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
                    if k == 0:
                        grad.update({n: float(g.norm()) for n, g in grads.items()})
                        gvec.update({n: g.detach() for n, g in grads.items()})
                    opt.step(grads, self.lr)
                    losses.append(float(loss.detach()))
        change = {n: float((p.detach() - p0[n]).norm()) for n, p in train.items()}
        return {"loss": losses, "grad": grad, "gvec": gvec, "change": change, "codes": codes}
