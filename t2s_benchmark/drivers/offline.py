"""Offline generation: a closed loop of requests, each a batch of captions -> wavs.

Set-up builds Diffsound from the configuration on the card with seeded
weights, builds the W4A8 static engine (``quantize_for_serving(weight_bits=4)``
and ``calibrate_serving_engine`` on a seeded caption batch) and MelGAN, and
serves one request to warm every shape. A request is the program's
``Diffsound.generate_int8`` on fresh seeded ids, ``to_spec`` and the
vocoder; its clock stops once its wavs are on the host. The rate counts the
clips of the requests that end inside the window, over the time from the
window's start to the end of the last of them.

The check (after the window, the program's state freed) takes one of the
mix's ``check_among_first`` finished requests, drawn from the seed, and
holds what the program produced for it to the reference: the text features,
the denoiser's hidden states and the sampled tokens at one step (the step's
input state and outputs are recorded as the timed path runs), the mel
decoded from the request's tokens, and the wav vocoded from that mel. The
step is recorded by a wrapper around the sampler kernel's module attribute,
installed for the picked request alone. ``offline_bf16`` runs the same loop
on the bf16 engine.
"""

import contextlib
import importlib
import math
import time

import torch

from .. import reference as ref
from .. import rates, roofline, traffic
from ..reference import codec as rcodec
from ..reference import denoiser as rden
from ..reference import sampler as rsamp
from ..trace import Phases
from ..weights import materialize, seeded_weights

# limits of the numbers the check compares; PERF.md gives the readings each was set from
LIMITS = {
    "text_rel_err": 3e-5,
    "hidden_rel_err": 0.11,
    "token_mismatch": 0.006,
    "mel_rel_err": 0.0075,
    "wav_rel_err": 0.005,
}


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _mismatch(a, b):
    return float((a.view(-1) != b.view(-1).long()).float().mean())


class Offline:
    # the sampler loop the traced run spans (module, function), the number the
    # recorded step is held to, and the text tower's control
    SAMPLER = ("text_to_sound_synthesis_torch.models.diffusion.int8_runtime",
               "sample_tokens_int8")
    STEP_NUMBER = "hidden_rel_err"
    LOWER_TEXT = staticmethod(ref.tf32)
    # the recorded step is drawn from the first CHECK_STEPS of the plan's second half
    CHECK_STEPS = 0.25

    def __init__(self, config: dict, mix: dict, seed: int, device, tracer):
        self.cfg, self.mix, self.seed, self.device, self.tracer = config, mix, seed, device, tracer
        m = config["model"]["params"]
        tp = m["diffusion_config"]["params"]["transformer_config"]["params"]
        self.dd = m["content_codec_config"]["params"]["ddconfig"]
        self.n_layer, self.n_head, self.D = tp["n_layer"], tp["n_head"], tp["n_embd"]
        self.L, self.S = tp["content_seq_len"], tp["condition_seq_len"]
        self.H, self.W = (int(v) for v in tp["content_spatial_size"])
        self.T = m["diffusion_config"]["params"]["diffusion_step"]
        self.K = m["content_codec_config"]["params"]["n_embed"] + 1
        self.batch = mix["batch"]
        self.tok = traffic.tokenizer(config)
        self.r = float(mix["sample_type"][3:-1])
        self.voc_cfg = dict(config["vocoder"])
        self.phases = Phases(device)
        cp = m["diffusion_config"]["params"]["condition_emb_config"]["params"]
        self.clip = dict(layers=cp.get("layers", 12), heads=cp.get("heads", 8))
        self.requests = []

    # -- set-up ---------------------------------------------------------------

    def _weights(self):
        from text_to_sound_synthesis_torch.models.diffsound import build_model
        from text_to_sound_synthesis_torch.models.melgan.generator import MelGANGenerator

        model = build_model(self.cfg, device="meta", load_codec=False)
        voc = MelGANGenerator(**self.voc_cfg).to("meta")
        wm = seeded_weights(model, self.seed, self.device)
        wv = seeded_weights(voc, self.seed + 1, self.device)
        return model, voc, wm, wv

    def setup(self):
        from text_to_sound_synthesis_torch.models.melgan.interface import Vocoder

        with self.phases("weights"):
            model, voc, wm, wv = self._weights()
            self.model = materialize(model, wm, self.device).eval()
            self.vocoder = Vocoder(materialize(voc, wv, self.device).eval())
        with self.phases("operation counts"):
            self.flops = self._count_flops(wm, wv)
        del wm, wv
        self.g_traffic, self.g_sample = traffic.streams(self.seed, self.device, 2)
        self._engine()
        # the request and the step whose outputs the check reads, drawn from the seed;
        # the step from early in the plan's second half: toward the plan's end a step
        # decides more tokens on near-ties, and its token mismatch grows to the control's
        self.capture_idx = self.T // 2 + self.seed % max(1, round(self.T * self.CHECK_STEPS))
        self.pick = self.seed % self.mix["check_among_first"]
        self._captured = None
        self._text = None
        self.model.cond.register_forward_hook(lambda mod, inp, out: setattr(self, "_text", out))
        with self.phases("warm-up request"):
            self.request()
        self.requests.clear()

    def _engine(self):
        """The W4A8 static engine, calibrated on a seeded caption batch."""
        self.cal_seed = self.seed + 2
        self.cal_ids = traffic.caption_ids(self.g_traffic, self.mix["calibration_batch"],
                                           self.mix["caption_tokens"], **self.tok)
        with self.phases("quantize_for_serving"):
            self.qp = self.model.quantize_for_serving(weight_bits=self.mix["weight_bits"])
        with self.phases("calibrate_serving_engine"):
            self.model.calibrate_serving_engine(
                self.qp, torch.Generator(self.device).manual_seed(self.cal_seed), self.cal_ids,
                sample_type=self.mix["sample_type"])

    @contextlib.contextmanager
    def _recording(self):
        """Keep K2's inputs and tokens at the check's step while the block runs."""
        from text_to_sound_synthesis_torch.ops import fused_sampler

        orig = fused_sampler.fused_head_sample

        def recording(x, xt, norm_out, head_w, head_b, coeffs, seed, step=0, **kw):
            out = orig(x, xt, norm_out, head_w, head_b, coeffs, seed, step, **kw)
            if step == self.capture_idx:
                self._captured = (x.clone(), xt.clone(), out.clone(), seed.clone())
            return out

        recording.launches = orig.launches
        fused_sampler.fused_head_sample = recording
        try:
            yield
        finally:
            fused_sampler.fused_head_sample = orig

    def _count_flops(self, wm, wv) -> dict:
        """Operations of one request by precision, from the shapes."""
        meta_m, meta_v = roofline.meta_like(wm), roofline.meta_like(wv)
        B = self.batch
        ids = torch.zeros((B, self.S), dtype=torch.long, device="meta")
        text = roofline.counted_flops(rden.clip_text, meta_m, ids, **self.clip)
        toks = torch.zeros((B, self.L), dtype=torch.long, device="meta")
        mel = roofline.counted_flops(rcodec.decode_tokens, meta_m, toks, self.dd, self.H, self.W)
        spec = torch.zeros((B, self.H * 16, self.W * 16), device="meta")
        wav = roofline.counted_flops(self._melgan, meta_v, spec)
        step = roofline.sampler_step_ops(B, self.L, self.S, self.D, self.n_head, self.n_layer,
                                         self.K)
        return self._by_precision(step, text, mel, wav)

    def _by_precision(self, step, text, mel, wav) -> dict:
        """The W4A8 engine: int8 dense products, bf16 attention and head, the
        text tower in f32, the codec's and the vocoder's convolutions in TF32."""
        return {"int8": self.T * step["dense"], "bf16": self.T * step["attn_head"], "f32": text,
                "tf32": mel + wav}

    # -- the window -------------------------------------------------------------

    def request(self):
        keep = len(self.requests) == self.pick
        t0 = time.perf_counter()
        with self.tracer.span("request"):
            ids = traffic.caption_ids(self.g_traffic, self.batch, self.mix["caption_tokens"],
                                      **self.tok)
            with self._recording() if keep else contextlib.nullcontext():
                mel, tokens = self._generate(ids)
            with self.tracer.span("vocode", sync=True):
                spec = (mel[..., 0].float() + 1.0) / 2.0
                wav = self.vocoder(spec)
            wav_host = wav.cpu()
        t1 = time.perf_counter()
        rec = dict(start=t0, end=t1, clips=ids.shape[0])
        if keep:
            rec.update(ids=ids, text=self._text, mel=mel, tokens=tokens, wav=wav_host,
                       step=self._captured)
        self.requests.append(rec)

    def _generate(self, ids):
        return self.model.generate_int8(self.qp, self.g_sample, ids,
                                        sample_type=self.mix["sample_type"], return_tokens=True)

    def run_window(self, seconds: float) -> dict:
        if self.tracer.enabled:
            self._span_program()
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.request()
        rate, done = rates.completed_rate(self.requests, start, seconds, "clips")
        if len(done) <= self.pick:
            raise RuntimeError(f"{len(done)} requests ended inside the {seconds} s window; "
                               f"the check reads request {self.pick}")
        self.done = done
        return {"clips_per_s": rate}

    def _span_program(self):
        """Synchronized spans around the sampler and the decoder (traced runs only)."""
        tracer, model = self.tracer, self.model
        module = importlib.import_module(self.SAMPLER[0])
        sample = getattr(module, self.SAMPLER[1])
        decode = model.decode_tokens

        def sampler(*a, **k):
            with tracer.span("sampler", sync=True):
                return sample(*a, **k)

        def decoder(*a, **k):
            with tracer.span("decode", sync=True):
                return decode(*a, **k)

        setattr(module, self.SAMPLER[1], sampler)
        model.decode_tokens = decoder

    def work(self) -> dict:
        clips = sum(r["clips"] for r in self.requests)
        return dict(clips=clips, requests=len(self.requests), steps_per_request=self.T,
                    request_ops=self.flops, **self._bounds())

    def _bounds(self) -> dict:
        return {"int8_step_bound_s": roofline.int8_step_bound(
            self.batch, self.L, self.S, self.D, self.n_head, self.n_layer, self.K)}

    def attempted(self):
        return len(self.requests), 0

    # -- the check --------------------------------------------------------------

    def release(self):
        pick = self.done[self.pick]
        self.picked = {k: pick[k] for k in ("ids", "text", "mel", "tokens", "wav", "step")}
        del self.model, self.vocoder, self.requests, self.done
        self.qp = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> dict:
        """{name: value} of the numbers compared; with ``control`` the reference
        itself, in the next lower precision, stands in the program's place."""
        model, voc, w, wv = self._weights()
        del model, voc
        p = self.picked
        self.detail = {"step": self.capture_idx, "request": self.pick}
        out = {}
        with torch.no_grad(), ref.full_f32():
            text_ref = rden.clip_text(w, p["ids"], **self.clip)
            if control:
                with self.LOWER_TEXT():
                    text_prog = rden.clip_text(w, p["ids"], **self.clip)
            else:
                text_prog = p["text"]
            out["text_rel_err"] = (float((text_prog.float() - text_ref).abs().max()
                                         / text_ref.abs().max())
                                   if text_prog.shape == text_ref.shape else float("inf"))
            x_prog, xt, tok_prog, seed_word = p["step"]
            B, L = p["ids"].shape[0], self.L
            rows = x_prog.numel() // x_prog.shape[-1]
            if xt.numel() == B * L and rows == B * L and tok_prog.numel() == B * L:
                out.update(self._step(w, text_ref, x_prog, xt.view(B, L), tok_prog,
                                      int(seed_word), control))
            else:                               # the step did not cover the whole batch
                out.update({self.STEP_NUMBER: float("inf"), "token_mismatch": 1.0})
            out["mel_rel_err"], mel_prog = self._mels(w, p, control)
            out["wav_rel_err"] = (self._wavs(wv, mel_prog, p, control) if mel_prog is not None
                                  else float("inf"))
        return out

    def _step(self, w, text_ref, x_prog, xt, tok_prog, seed_word: int, control: bool):
        """{hidden_rel_err, token_mismatch} at the recorded step: the reference's
        hidden states on the step's input tokens (its W4A8 arithmetic on its own
        calibration), and the tokens the reference's posterior picks under the
        kernel's own Gumbel noise for that step."""
        amax = self._calibrate(w)
        B, L = xt.shape
        t = self._t(B)
        x_ref = rden.denoiser(w, xt, t, text_ref, quant=rden.Quant(self.n_layer, amax=amax),
                              **self._dims())
        next_tokens = self._posterior_argmax(xt, t, seed_word)
        tok_ref = next_tokens(rden.head_logits(w, x_ref))
        if control:
            x_prog = rden.denoiser(w, xt, t, text_ref,
                                   quant=rden.Quant(self.n_layer, abits=4, amax=amax),
                                   **self._dims())
            tok_prog = next_tokens(rden.head_logits(w, x_prog))
        return {"hidden_rel_err": _rel(x_prog.reshape(x_ref.shape), x_ref),
                "token_mismatch": _mismatch(tok_ref, tok_prog)}

    def _t(self, B: int):
        return torch.full((B,), self.T - 1 - self.capture_idx, device=self.device)

    def _dims(self) -> dict:
        return dict(n_layer=self.n_layer, n_head=self.n_head, H=self.H, W=self.W)

    def _posterior_argmax(self, xt, t, seed_word: int):
        """logits -> the tokens the reference's posterior picks under the sampler
        kernel's own Gumbel noise for (``seed_word``, the recorded step)."""
        B, L = xt.shape
        sch = rsamp.schedule(self.T, self.K, self.device)
        g = rsamp.kernel_gumbel(B * L, self.K, seed_word & 0xFFFFFFFF, self.capture_idx,
                                self.device).view(B, L, self.K)

        def next_tokens(logits):
            lx0 = rsamp.log_x0_from_logits(logits, self.r)
            return (rsamp.q_posterior(sch, lx0, xt, t) + g).argmax(-1)

        return next_tokens

    def _calibrate(self, w):
        """The reference's static scales: the engine's calibration (per-row int8
        activations, W4 weights, the serving truncation) on the same captions,
        with the same generator's draws, over the whole timestep plan."""
        B, L, K = self.cal_ids.shape[0], self.L, self.K
        cond = rden.clip_text(w, self.cal_ids, **self.clip)
        q = rden.Quant(self.n_layer, amax=None, record=True)
        sch = rsamp.schedule(self.T, K, self.device)
        gen = torch.Generator(self.device).manual_seed(self.cal_seed)
        tokens = torch.full((B, L), K - 1, dtype=torch.long, device=self.device)
        for t_int in range(self.T - 1, -1, -1):
            t = torch.full((B,), t_int, device=self.device)
            x = rden.denoiser(w, tokens, t, cond, quant=q, **self._dims())
            lx0 = rsamp.log_x0_from_logits(rden.head_logits(w, x), self.r)
            post = rsamp.q_posterior(sch, lx0, tokens, t)
            u = torch.rand(post.shape, generator=gen, device=self.device)
            tokens = (post + rsamp.gumbel_from_uniform(u)).argmax(-1)
        return q.seen

    def _mels(self, w, p, control: bool):
        tokens, num, den, outs = p["tokens"], 0.0, 0.0, []
        for i in range(0, tokens.shape[0], self.mix["check_block"]):
            blk = tokens[i:i + self.mix["check_block"]]
            r_mel = rcodec.decode_tokens(w, blk, self.dd, self.H, self.W)
            if control:
                prog = self._lower_decode(w, blk)
            else:
                prog = p["mel"][i:i + blk.shape[0]].permute(0, 3, 1, 2).float()
            if prog.shape != r_mel.shape:
                return float("inf"), None
            outs.append(prog)
            num += float((prog - r_mel).square().sum())
            den += float(r_mel.square().sum())
        return math.sqrt(num / den), torch.cat(outs)

    def _lower_decode(self, w, tokens):
        """The codec's decoder in bf16 (the control of its TF32 convolutions)."""
        wb = {k: v.bfloat16() for k, v in w.items() if k.startswith(rcodec.CODEC)}
        return rcodec.decode_tokens(wb, tokens, self.dd, self.H, self.W).float()

    def _melgan(self, wv, spec):
        return rcodec.melgan(wv, spec, ngf=self.voc_cfg["ngf"],
                             n_residual_layers=self.voc_cfg["n_residual_layers"])

    def _wavs(self, wv, mel_prog, p, control: bool):
        num, den = 0.0, 0.0
        for i in range(0, mel_prog.shape[0], self.mix["check_block"]):
            spec = (mel_prog[i:i + self.mix["check_block"], 0] + 1.0) / 2.0
            r_wav = self._melgan(wv, spec)
            if control:
                wb = {k: v.bfloat16() for k, v in wv.items()}
                prog = self._melgan(wb, spec.bfloat16()).float()
            else:
                prog = p["wav"][i:i + spec.shape[0]].to(self.device).float()
            if prog.shape != r_wav.shape:
                return float("inf")
            num += float((prog - r_wav).square().sum())
            den += float(r_wav.square().sum())
        return math.sqrt(num / den)


DRIVER = "Offline"
# what stands in the program's place for the control: the reference one precision
# lower (the text tower in TF32, the denoiser on an A4 grid, codec and vocoder in bf16)
CONTROLS = ("lower_precision",)
