"""Whole runs of each cell at a tiny size on the CPU: sound, the control, and planted faults.

A sound run comes out correct. With the timed path broken underneath (a
step that returns its state unchanged, half of the batch left out, a token
or an answer altered where it is produced) the same run comes out not
correct. The control (the reference in the program's place, one precision
lower) has to fail a number too: at this size the offline cells' controls
(the W4A4 denoiser, the float8 reference) do on the CPU; the training
cells' controls (TF32, bf16) run on the card.
The harness's look for a card is skipped; everything else runs as on the chip.
"""

import inspect

import torch
import pytest

from t2s_benchmark import tiny_cells
from t2s_benchmark.drivers import offline, offline_bf16, stage1, stage2
from t2s_benchmark.trace import Tracer

CELLS = ("caps.w4a8.b64", "caps.bf16.b64", "caps.train.f32", "vqgan.train")
# each offline cell: its sampler kernel (where a token is produced) and its entry point
OFFLINE = [("caps.w4a8.b64", "fused_head_sample", "generate_int8"),
           ("caps.bf16.b64", "fused_p_sample", "generate")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = tiny_cells.run_tiny(cell, seed=2000000011)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", [c for c, _, _ in OFFLINE])
def test_a_traced_run_reports_per_layer_metrics(cell):
    out = tiny_cells.run_tiny(cell, trace=1)
    assert out["correct"]
    assert {"sampler_ms_per_step.offline", "decode_vocode_ms_per_clip.offline",
            "mfu_pct.offline"} <= set(out["metrics"])
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0


def _sampler_fault(monkeypatch, kernel, alter):
    from text_to_sound_synthesis_torch.ops import fused_sampler

    orig = getattr(fused_sampler, kernel)
    sig = inspect.signature(orig)

    def broken(*a, **kw):
        args = sig.bind(*a, **kw).arguments
        return alter(orig(*a, **kw), args["xt"], args.get("step", 0))

    broken.launches = 0
    monkeypatch.setattr(fused_sampler, kernel, broken)


def _state_unchanged(out, xt, step):
    return out if step == 11 else xt            # every step but the last keeps its input


def _token_altered(out, xt, step):
    out = out.clone()
    out[::7] = (out[::7] + 1) % 64
    return out


@pytest.mark.parametrize("alter", [_state_unchanged, _token_altered])
@pytest.mark.parametrize("cell,kernel,entry", OFFLINE)
def test_offline_sampler_faults_are_caught(monkeypatch, cell, kernel, entry, alter):
    _sampler_fault(monkeypatch, kernel, alter)
    assert not tiny_cells.run_tiny(cell)["correct"]


@pytest.mark.parametrize("cell,kernel,entry", OFFLINE)
def test_offline_half_batch_is_caught(monkeypatch, cell, kernel, entry):
    from text_to_sound_synthesis_torch.models.diffsound import Diffsound

    orig = getattr(Diffsound, entry)

    def half(self, *a, **kw):                   # the caption ids come last
        ids = a[-1]
        mel, tokens = orig(self, *a[:-1], ids[: ids.shape[0] // 2], **kw)
        return mel.repeat(2, 1, 1, 1), tokens.repeat(2, 1)

    monkeypatch.setattr(Diffsound, entry, half)
    assert not tiny_cells.run_tiny(cell)["correct"]


@pytest.mark.parametrize("cell,kernel,entry", OFFLINE)
def test_offline_answer_altered_is_caught(monkeypatch, cell, kernel, entry):
    from text_to_sound_synthesis_torch.models.melgan.interface import Vocoder

    orig = Vocoder.__call__
    monkeypatch.setattr(Vocoder, "__call__", lambda self, spec: orig(self, spec) * 1.1)
    assert not tiny_cells.run_tiny(cell)["correct"]


def _optimizer_keeps_state(monkeypatch, cls):
    orig = cls.step

    def unchanged(self, *a, **k):
        before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = orig(self, *a, **k)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(cls, "step", unchanged)


def test_train_state_unchanged_is_caught(monkeypatch):
    _optimizer_keeps_state(monkeypatch, torch.optim.AdamW)
    assert not tiny_cells.run_tiny("caps.train.f32")["correct"]


def test_stage1_state_unchanged_is_caught(monkeypatch):
    _optimizer_keeps_state(monkeypatch, torch.optim.Adam)
    assert not tiny_cells.run_tiny("vqgan.train")["correct"]


def test_train_half_batch_is_caught(monkeypatch):
    from text_to_sound_synthesis_torch.models.diffsound import Diffsound

    orig = Diffsound.loss

    def half(self, mel, ids, t, pt, *, gumbel=None, **kw):
        h = mel.shape[0] // 2
        out = orig(self, mel[:h], ids[:h], t[:h], pt[:h], gumbel=gumbel[:h], **kw)
        rep = lambda v: v.repeat(2)
        return out._replace(kl_loss=rep(out.kl_loss), t=t, acc_x0=rep(out.acc_x0),
                            acc_keep=rep(out.acc_keep))

    monkeypatch.setattr(Diffsound, "loss", half)
    assert not tiny_cells.run_tiny("caps.train.f32")["correct"]


def test_train_token_altered_is_caught(monkeypatch):
    from text_to_sound_synthesis_torch.models.diffsound import Diffsound

    orig = Diffsound.encode_content

    def altered(self, mel):
        tokens = orig(self, mel).clone()
        tokens[:, ::5] = (tokens[:, ::5] + 1) % 64
        return tokens

    monkeypatch.setattr(Diffsound, "encode_content", altered)
    assert not tiny_cells.run_tiny("caps.train.f32")["correct"]


def test_stage1_half_batch_is_caught(monkeypatch):
    # inside the losses: the codec still encodes the whole batch, so the codes
    # the step returns keep their shape and the losses have to show the fault
    from text_to_sound_synthesis_torch.engine import vqgan_solver

    nll, d_loss = vqgan_solver._nll, vqgan_solver.hinge_d_loss
    half = lambda x: x[: x.shape[0] // 2]
    monkeypatch.setattr(vqgan_solver, "_nll",
                        lambda cfg, lpaps, mel, xrec: nll(cfg, lpaps, half(mel), half(xrec)))
    monkeypatch.setattr(vqgan_solver, "hinge_d_loss",
                        lambda real, fake: d_loss(half(real), half(fake)))
    out = tiny_cells.run_tiny("vqgan.train")
    assert out["checks"]["code_mismatch"]["value"] < 1.0
    assert not out["correct"]


def test_stage1_answer_altered_is_caught(monkeypatch):
    from text_to_sound_synthesis_torch.models.vqgan.model import VQModel

    orig = VQModel.decode
    monkeypatch.setattr(VQModel, "decode", lambda self, q: orig(self, q) + 0.05)
    assert not tiny_cells.run_tiny("vqgan.train")["correct"]


@pytest.mark.parametrize("mod,cell", [(offline, "caps.w4a8.b64"),
                                      (offline_bf16, "caps.bf16.b64")])
def test_offline_control_is_not_correct(mod, cell):
    config, mix = tiny_cells.CELLS[cell]()
    dev = torch.device("cpu")
    d = getattr(mod, mod.DRIVER)(config, mix, 7, dev, Tracer(False, dev))
    d.setup()
    d.run_window(tiny_cells.WINDOW_S)
    d.release()
    readings = d.check(control="lower_precision")
    assert any(v > mod.LIMITS[k] for k, v in readings.items()), readings


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the training controls run on a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mod,cell", [(stage2, "caps.train.f32"), (stage1, "vqgan.train")])
def test_train_control_is_not_correct(card, mod, cell):
    config, mix = tiny_cells.CELLS[cell]()
    d = getattr(mod, mod.DRIVER)(config, mix, 7, card, Tracer(False, card))
    d.setup()
    d.run_window(tiny_cells.WINDOW_S)
    d.release()
    readings = d.check(control=mod.CONTROLS[0])
    assert any(v > mod.LIMITS[k] for k, v in readings.items()), readings
