"""Offline generation on the bf16 engine: the closed loop of ``offline``, on
``Diffsound.generate`` with the fused sampler (K1) in the mix's compute dtype.

Set-up builds Diffsound and MelGAN as ``offline`` does, sets the model's
compute dtype to the mix's ``dtype`` (the text tower, the denoiser and the
codec then run on bf16 copies of the seeded f32 weights, as the ``generate``
CLI runs a configuration that states ``dtype: bfloat16``; MelGAN stays f32),
and serves one request to warm every shape. Nothing is quantized or
calibrated.

The check holds the picked request to the f32 reference as ``offline`` does,
with the denoiser's logits at the recorded step in place of the W4A8 hidden
states; the control is the reference with every matmul and convolution in
float8 e4m3 (the vocoder, which runs in f32, in bf16).
"""

import contextlib

from .. import reference as ref
from ..reference import codec as rcodec
from ..reference import denoiser as rden
from .offline import Offline, _mismatch, _rel

DRIVER = "OfflineBF16"
# limits of the numbers the check compares; PERF.md gives the readings each was set from
LIMITS = {
    "text_rel_err": 0.05,
    "logits_rel_err": 0.045,
    "token_mismatch": 0.0012,
    "mel_rel_err": 0.06,
    "wav_rel_err": 0.005,
}
CONTROLS = ("lower_precision",)


class OfflineBF16(Offline):
    SAMPLER = ("text_to_sound_synthesis_torch.models.diffsound", "sample_tokens_fused")
    STEP_NUMBER = "logits_rel_err"
    LOWER_TEXT = staticmethod(ref.fp8)
    # steps 50-57 of 100: later, sound runs' token mismatch grows toward the
    # float8 control's (PERF.md gives the readings by step)
    CHECK_STEPS = 0.08

    def _engine(self):
        self.model.dtype = self.mix["dtype"]

    @contextlib.contextmanager
    def _recording(self):
        """Keep K1's inputs and tokens at the check's step while the block runs."""
        from text_to_sound_synthesis_torch.ops import fused_sampler

        orig = fused_sampler.fused_p_sample

        def recording(logits, xt, coeffs, seed, step=0, **kw):
            out = orig(logits, xt, coeffs, seed, step, **kw)
            if step == self.capture_idx:
                self._captured = (logits.clone(), xt.clone(), out.clone(), seed.clone())
            return out

        recording.launches = orig.launches
        fused_sampler.fused_p_sample = recording
        try:
            yield
        finally:
            fused_sampler.fused_p_sample = orig

    def _generate(self, ids):
        return self.model.generate(self.g_sample, ids, sample_type=self.mix["sample_type"],
                                   return_tokens=True)

    def _by_precision(self, step, text, mel, wav) -> dict:
        """Every part in bf16 but the vocoder's convolutions (TF32)."""
        return {"bf16": self.T * (step["dense"] + step["attn_head"]) + text + mel,
                "tf32": wav}

    def _bounds(self) -> dict:
        return {}

    def _step(self, w, text_ref, logits_prog, xt, tok_prog, seed_word: int, control: bool):
        """{logits_rel_err, token_mismatch} at the recorded step: the reference's
        logits on the step's input tokens, and the tokens its posterior picks
        under K1's own Gumbel noise for that step."""
        B, L = xt.shape
        t = self._t(B)
        logits_ref = rden.head_logits(w, rden.denoiser(w, xt, t, text_ref, **self._dims()))
        next_tokens = self._posterior_argmax(xt, t, seed_word)
        tok_ref = next_tokens(logits_ref)
        if control:
            with ref.fp8():
                text = rden.clip_text(w, self.picked["ids"], **self.clip)
                logits_prog = rden.head_logits(w, rden.denoiser(w, xt, t, text, **self._dims()))
            tok_prog = next_tokens(logits_prog)
        return {"logits_rel_err": _rel(logits_prog.reshape(logits_ref.shape), logits_ref),
                "token_mismatch": _mismatch(tok_ref, tok_prog)}

    def _lower_decode(self, w, tokens):
        """The codec's decoder in float8 (the control of its bf16 convolutions)."""
        with ref.fp8():
            return rcodec.decode_tokens(w, tokens, self.dd, self.H, self.W)
