"""``chip_smoke.py``'s int8 token gate on synthetic step tuples, on the CPU.

A step tuple is what ``chip_smoke._step_tail`` returns: tokens, scores,
log-probs, the log threshold and the nucleus. The plain path's tuple is
drawn from a seed; a path's error is a seeded noise added to its scores,
log-probs and threshold. The old rule (``_tie_band`` +  ``_flip_rows``:
every flip a near-tie within the band the path's own unflipped rows show)
passes a uniform rise of every row's error, since the band rises with it;
the ceiling (``_band_within``: the band within BAND_RATIO times a reference
band) catches it. ``_ulp_nudge``, which makes the reference, moves its share
of the elements by exactly one ulp."""

import pytest
import torch

import chip_smoke

M, K = 4096, 64


def _tuple(s, lp, lt):
    tokens = s.argmax(dim=-1).int()
    keep = (lp > lt[:, None]) | (lp == lp.amax(dim=-1, keepdim=True))
    return tokens, s, lp, lt, keep


def _plain():
    g = torch.Generator().manual_seed(0)
    s = 3.0 * torch.randn(M, K, generator=g)
    lp = torch.log_softmax(2.0 * torch.randn(M, K, generator=g), dim=-1)
    lt = lp.sort(dim=-1, descending=True).values[:, 4:6].mean(dim=-1)
    return s, lp, lt


def _path(scale, seed):
    """The plain tuple with every row's error ``scale`` times one seeded noise."""
    s, lp, lt = _plain()
    g = torch.Generator().manual_seed(seed)
    n = lambda shape: scale * 1e-2 * torch.randn(shape, generator=g)
    return _tuple(s + n(s.shape), lp + n(lp.shape), lt + n(lt.shape))


def _old_rule(plain, path):
    band = chip_smoke._tie_band(plain, path)
    return chip_smoke._flip_rows(plain, path, band)[1] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_uniform_rise_passes_the_band_and_fails_the_ceiling(seed):
    plain, ref = _tuple(*_plain()), _path(1.0, 100 + seed)
    ref_band = chip_smoke._tie_band(plain, ref)
    kern = _path(1.0, seed)
    assert chip_smoke._flip_rows(plain, kern, chip_smoke._tie_band(plain, kern))[0] > 0
    assert _old_rule(plain, kern)
    assert chip_smoke._band_within(chip_smoke._tie_band(plain, kern), ref_band)
    rise = 2.0 * chip_smoke.BAND_RATIO
    risen = _path(rise, seed)
    assert chip_smoke._flip_rows(plain, risen, chip_smoke._tie_band(plain, risen))[0] > 0
    assert _old_rule(plain, risen)
    assert not chip_smoke._band_within(chip_smoke._tie_band(plain, risen), ref_band)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ulp_nudge_moves_its_share_by_one_ulp(dtype):
    x = torch.randn(20000, generator=torch.Generator().manual_seed(5)).to(dtype)
    x[::7] = 0
    x[3] = torch.finfo(dtype).max
    y = chip_smoke._ulp_nudge(x, torch.Generator().manual_seed(6))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    d = y.view(bits).long() - x.view(bits).long()
    assert int(d.abs().max()) == 1 and bool(torch.isfinite(y).all())
    assert bool((y[::7] == 0).all())
    moved = float((d != 0).float().mean()) / (6 / 7)
    assert abs(moved - chip_smoke.REF_ULP_SHARE) < 0.02
    up = int((y.float().abs() > x.float().abs()).sum())
    down = int((y.float().abs() < x.float().abs()).sum())
    assert abs(up - down) < 0.05 * (up + down)
