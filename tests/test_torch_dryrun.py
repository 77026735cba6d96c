"""The port's dry-run entry points (``tools/dryrun.py``) on the CPU:
``entry()`` at the small geometry gives finite log-probabilities of the
right shape, and ``dryrun_multichip(2)`` passes on a 2-process gloo group
at JAX's mesh of (1, 2) with a global batch of 2 (fresh interpreters: one
Stage-2 train step with the denoiser split over the model axis, both
sharded samplers over the data group, a model group's weights and tokens
equal, no MASK left)."""

import subprocess
import sys

import pytest
import torch

from text_to_sound_synthesis_torch.tools import dryrun

torch.set_num_threads(1)


def test_entry_tiny_on_cpu():
    fn, args = dryrun.entry(device="cpu", tiny=True)
    model, tokens, cond, t = args
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    out = fn(*args)
    assert tuple(out.shape) == (1, 16, 17) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    # log p(x0 | x_t): the MASK column at -70, the real classes summing to 1
    assert bool((out[..., -1] == -70).all())
    torch.testing.assert_close(out[..., :-1].exp().sum(-1), torch.ones(1, 16), atol=1e-3,
                               rtol=0)


def test_dryrun_multichip_two_ranks_gloo(capfd):
    dryrun.dryrun_multichip(2, device="cpu")
    assert ("dryrun_multichip OK: mesh (1, 2) of 2 rank(s) on cpu (gloo), batch 2"
            in capfd.readouterr().out)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        dryrun.entry()
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(1)
    r = subprocess.run([sys.executable, "-m", "text_to_sound_synthesis_torch.tools.dryrun"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA card" in r.stderr and r.stdout == ""
