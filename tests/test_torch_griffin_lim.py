"""The port's Griffin-Lim half of ``ops/signal.py`` against the JAX package's.

The NNLS mel inversion is float64 numpy, copied unchanged: bit for bit. The
inverse STFT and the complex STFT are f32 FFTs on both sides (torch's
pocketfft, XLA's ducc): within atol 1e-5 on inputs of audio scale.
Griffin-Lim normalises each bin's update to a unit phase, which turns the
f32 rounding of near-zero bins into whole phase differences that the next
step carries on: after 4 steps on a 0.25 s tone the two waveforms are 0.999
correlated and within 1e-2 of each other (peak 0.69; measured 5.4e-3),
while step 0 (the zero-phase start alone) agrees to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_torch.ops import signal as P
from text_to_sound_synthesis_tpu.ops import signal as J

torch.set_num_threads(1)

SR = 22050


def _tone(seconds):
    t = np.arange(int(SR * seconds)) / SR
    return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


@pytest.mark.parametrize("frames,seed", [(40, 0), (7, 1)])
def test_mel_to_stft_np_bit_for_bit(frames, seed):
    mel01 = np.random.default_rng(seed).random((80, frames))
    want = J._mel_to_stft_np(J.denormalize_mel_np(mel01), J.CANONICAL)
    got = P._mel_to_stft_np(P.denormalize_mel_np(mel01), P.CANONICAL)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_istft_matches_jax(lead):
    rng = np.random.default_rng(3)
    shape = lead + (513, 12)
    spec = (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)
    want = np.asarray(J._istft(jnp.asarray(spec), J.CANONICAL))
    got = P._istft(torch.from_numpy(spec), P.CANONICAL).numpy()
    assert got.shape == want.shape == lead + (256 * 11,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg", [P.CANONICAL, P.MelConfig(win_length=512)], ids=["hann1024", "win512"])
def test_stft_magnitude_complex_matches_jax(cfg):
    y = np.random.default_rng(4).uniform(-0.5, 0.5, (2, 4000)).astype(np.float32)
    jcfg = J.MelConfig(win_length=cfg.win_length)
    want = np.asarray(J.stft_magnitude_complex(jnp.asarray(y), jcfg))
    got = P.stft_magnitude_complex(torch.from_numpy(y), cfg).numpy()
    assert got.shape == want.shape == (2, 513, 16) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_griffin_lim_matches_jax():
    mag = np.abs(J.stft_magnitude_np(_tone(0.25), 1024, 256)).astype(np.float32)
    jmag, tmag = jnp.asarray(mag), torch.from_numpy(mag)
    start = P.griffin_lim(tmag, P.CANONICAL, n_iter=0).numpy()
    np.testing.assert_allclose(start, np.asarray(J.griffin_lim(jmag, J.CANONICAL, n_iter=0)),
                               rtol=0, atol=1e-6)
    want = np.asarray(J.griffin_lim(jmag, J.CANONICAL, n_iter=4))
    got = P.griffin_lim(tmag, P.CANONICAL, n_iter=4).numpy()
    assert got.shape == want.shape == (256 * (mag.shape[1] - 1),)
    assert np.abs(got - want).max() <= 1e-2
    assert np.corrcoef(got, want)[0, 1] > 0.999


def test_griffin_lim_batched_rows_are_single_rows():
    mag = np.abs(J.stft_magnitude_np(_tone(0.1), 1024, 256)).astype(np.float32)
    mags = torch.from_numpy(np.stack([mag, 0.5 * mag]))
    both = P.griffin_lim(mags, P.CANONICAL, n_iter=2)
    for i in range(2):
        torch.testing.assert_close(both[i], P.griffin_lim(mags[i], P.CANONICAL, n_iter=2),
                                   rtol=0, atol=1e-6)


def test_griffinlim_roundtrip_tone():
    """A pure tone survives mel -> NNLS -> GL -> mel with correlation > 0.95
    (the JAX package's gate, at half its length)."""
    y = _tone(1.0)
    mel = P.wav_to_mel_np(y)
    y_rec = P.mel_to_wav_np(mel, n_iter=16, device="cpu")
    assert y_rec.dtype == np.float32 and np.isfinite(y_rec).all()
    mel_rec = P.wav_to_mel_np(y_rec[: len(y)])
    L = min(mel.shape[1], mel_rec.shape[1]) - 2
    corr = np.corrcoef(mel[:, 1:L].ravel(), mel_rec[:, 1:L].ravel())[0, 1]
    assert corr > 0.95, corr


def test_mel_to_wav_np_defaults_to_the_card():
    mel = P.wav_to_mel_np(_tone(0.05))
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        P.mel_to_wav_np(mel, n_iter=1)
