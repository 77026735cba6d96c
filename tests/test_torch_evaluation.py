"""The port's evaluation against the JAX package: the fidelity metrics, the
Melception network, and ``extract_features`` / ``evaluate_folders``.

* The metrics (``evaluation/metrics.py``) are the port's own copy of numpy
  and scipy code: equal to JAX's results exactly.
* Melception, weights drawn with numpy on JAX's parameter shapes
  (``jax.eval_shape``, no init) and carried across by
  ``convert/from_jax.py::load_melception``: every Inception block at a tiny
  spatial size, the whole net at (1, 80, 64) with 9 classes on every tap,
  within atol 1e-5 and rtol 1e-4 (the JAX package's tolerance for its torch
  transcription, ``tests/test_melception_full.py``). The other direction
  too: the port's state dict with random BatchNorm statistics through JAX's
  ``convert_melception`` gives the JAX model the port's outputs, which pins
  the torchvision names.
* The folder pipeline on mels of 24 x 32, the smallest height whose maps
  stay non-empty through Mixed_7a (at 16 rows JAX's VALID convs leave an
  empty map and NaN features; torch refuses the input): features within the
  same tolerance, the metrics within rtol 1e-6 (the FID within 1e-4 of the
  traces it sums: ``sqrtm`` of a rank-deficient covariance product
  amplifies the features' f32 rounding).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.evaluation import features as PF
from text_to_sound_synthesis_torch.evaluation import metrics as PM
from text_to_sound_synthesis_torch.models import melception as PMel
from text_to_sound_synthesis_torch.models.melception import model as PMM
from text_to_sound_synthesis_tpu.convert.torch_to_jax import convert_melception
from text_to_sound_synthesis_tpu.evaluation import features as JF
from text_to_sound_synthesis_tpu.evaluation import metrics as JM
from text_to_sound_synthesis_tpu.models.melception import model as JMM

torch.set_num_threads(1)

TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """scipy's ``sqrtm`` of a 2048-d FID gains little from BLAS threads and
    starves the suite's other workers of cores: one thread here."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _draw(shapes, seed):
    """Numpy draws on a Melception tree of shapes: conv kernels N(0, 1/fan_in)
    (activations keep their scale through the 94 convs), folded BatchNorm
    scales near 1, shifts and the head small."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "bn_scale":
            return rng.uniform(0.7, 1.1, s.shape).astype(np.float32)
        if name == "bn_shift":
            return rng.normal(0, 0.05, s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _randomize_bn(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3, generator=g)
                m.running_var.uniform_(0.7, 1.5, generator=g)
                m.weight.normal_(1, 0.1, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    return module


# ---------------------------------------------------------------------------
# the metrics: the port's copy against the JAX package's
# ---------------------------------------------------------------------------

def _feats(kind, seed, n, d):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((n, d))
    if kind == "shifted":
        return rng.standard_normal((n, d)) + np.linspace(-1, 1, d)
    return rng.random((n, d)).astype(np.float32)          # f32, as features come


@pytest.mark.parametrize("a,b,n", [("normal", "normal", 50), ("normal", "shifted", 40),
                                   ("f32", "f32", 12), ("normal", "normal", 5)])
def test_fid_equals_jax(a, b, n):
    f1, f2 = _feats(a, 1, n, 16), _feats(b, 2, n + 3, 16)
    assert PM.calculate_fid(f1, f2) == JM.calculate_fid(f1, f2)


def test_fid_on_a_scipy_without_disp(monkeypatch):
    """Newer scipy's ``sqrtm`` takes no ``disp`` and returns the root alone."""
    import scipy.linalg

    f1, f2 = _feats("normal", 1, 30, 16), _feats("shifted", 2, 33, 16)
    want = JM.calculate_fid(f1, f2)
    real = scipy.linalg.sqrtm
    monkeypatch.setattr(scipy.linalg, "sqrtm", lambda A: real(A, disp=False)[0])
    assert PM.calculate_fid(f1, f2) == want


@pytest.mark.parametrize("n,splits,shuffle", [(500, 10, True), (37, 5, False), (3, 10, True)])
def test_isc_equals_jax(n, splits, shuffle):
    logits = np.random.default_rng(n).standard_normal((n, 9)) * 3
    assert (PM.calculate_isc(logits, samples_shuffle=shuffle, splits=splits)
            == JM.calculate_isc(logits, samples_shuffle=shuffle, splits=splits))


@pytest.mark.parametrize("subset,degree,gamma", [(100, 3, None), (7, 2, 0.5), (1000, 3, "none")])
def test_kid_equals_jax(subset, degree, gamma):
    f1, f2 = _feats("normal", 3, 120, 16), _feats("shifted", 4, 90, 16)
    kw = dict(subsets=10, subset_size=subset, degree=degree, gamma=gamma)
    assert PM.calculate_kid(f1, f2, **kw) == JM.calculate_kid(f1, f2, **kw)


@pytest.mark.parametrize("path,dataset,classes", [
    ("x/y/clip12_sample_3.npy", "caps", None), ("x/y/clip12_mel.npy", "caps", None),
    ("v/abc_sample_1.npy", "vggsound", None),
    ("melspec_10s_22050hz/cls_1/dog_mel_sample_2.npy", "vas", ["cat", "dog"]),
    ("gen/cls_0/a_b_sample_0.npy", "VAS", ["dog", "cat"])])
def test_path_to_sharedkey_equals_jax(path, dataset, classes):
    assert (PM.path_to_sharedkey(path, dataset, classes)
            == JM.path_to_sharedkey(path, dataset, classes))


@pytest.mark.parametrize("shuffle", [False, True])
def test_kl_equals_jax(shuffle):
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((3, 6))
    paths_2 = [f"gt/c{i}_mel.npy" for i in range(3)]
    gen = np.concatenate([ref + 0.3 * rng.standard_normal(ref.shape) for _ in range(2)])
    paths_1 = [f"gen/c{i % 3}_sample_{i // 3}.npy" for i in range(6)]
    if shuffle:
        order = rng.permutation(6)
        gen, paths_1 = gen[order], [paths_1[i] for i in order]
    assert (PM.calculate_kl(gen, paths_1, ref, paths_2)
            == JM.calculate_kl(gen, paths_1, ref, paths_2))
    with pytest.raises(ValueError, match="no overlapping clip keys"):
        PM.calculate_kl(gen, paths_1, ref, ["gt/other_mel.npy"] * 3)


# ---------------------------------------------------------------------------
# Melception
# ---------------------------------------------------------------------------

BLOCKS = [  # (JAX block, port block, input channels, H, W)
    (lambda: JMM.InceptionA(16), lambda: PMM.InceptionA(32, 16), 32, 7, 9),
    (lambda: JMM.InceptionB(), lambda: PMM.InceptionB(32), 32, 7, 9),
    (lambda: JMM.InceptionC(24), lambda: PMM.InceptionC(40, 24), 40, 8, 9),
    (lambda: JMM.InceptionD(), lambda: PMM.InceptionD(40), 40, 7, 8),
    (lambda: JMM.InceptionE(), lambda: PMM.InceptionE(48), 48, 3, 5),
    (lambda: JMM.BasicConv2d(12, (3, 3), strides=(2, 2), padding=(1, 0)),
     lambda: torch.nn.ModuleDict({"b": PMM.BasicConv2d(5, 12, 3, stride=2, padding=(1, 0))}),
     5, 9, 8),
]


@pytest.mark.parametrize("i", range(len(BLOCKS)), ids=["A", "B", "C", "D", "E", "conv"])
def test_inception_block_matches_jax(i):
    jnew, pnew, cin, H, W = BLOCKS[i]
    x = np.random.default_rng(i).standard_normal((2, cin, H, W)).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    jb = jnew()
    params = _draw(jax.eval_shape(jb.init, jax.random.PRNGKey(0), xj), 10 + i)
    want = np.asarray(jb.apply(params, xj))
    if i == 5:      # a lone BasicConv2d: its tree under a block named "b"
        params = {"params": {"b": params["params"]}}
    pb = from_jax.load_melception(pnew(), params).eval()
    with torch.no_grad():
        got = (pb["b"] if i == 5 else pb)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)


def test_unit_variance_makes_batchnorm_the_folded_affine():
    """``running_var = 1 - 1e-3`` and eps 1e-3 sum to 1.0 in f32, so the
    eval-mode BatchNorm's 1 / sqrt(var + eps) is 1 and it computes x * weight
    + bias: equal up to the rounding of one multiply-add (fused or not)."""
    v = from_jax.MELCEPTION_UNIT_VAR
    assert v.dtype == np.float32 and v + np.float32(1e-3) == np.float32(1.0)
    bn = torch.nn.BatchNorm2d(4, eps=1e-3).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        bn.weight.normal_(generator=g)
        bn.bias.normal_(generator=g)
        bn.running_var.fill_(float(v))
        x = torch.randn((3, 4, 5, 6), generator=g)
        w, b = bn.weight[:, None, None], bn.bias[:, None, None]
        bound = 2.0**-23 * ((x * w).abs() + b.abs())
        assert bool(((bn(x) - (x * w + b)).abs() <= bound).all())


@pytest.fixture(scope="module")
def whole_net():
    mel = np.random.default_rng(0).standard_normal((1, 80, 64)).astype(np.float32)
    jm = JMM.Melception(num_classes=9, features_list=TAPS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(mel))
    return jm, jax.jit(jm.apply), shapes, mel


def test_melception_matches_jax_on_every_tap(whole_net):
    jm, apply, shapes, mel = whole_net
    params = _draw(shapes, 1)
    want = apply(params, jnp.asarray(mel))
    pm = from_jax.load_melception(PMel.Melception(num_classes=9, features_list=TAPS), params)
    assert not pm.training
    with torch.no_grad():
        got = pm(torch.from_numpy(mel))
    assert sorted(got) == sorted(TAPS)
    for k in TAPS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_port_state_dict_through_jax_converter(whole_net):
    """torchvision's names: the port's state dict, with random BatchNorm
    statistics, through JAX's ``convert_melception``."""
    jm, apply, shapes, mel = whole_net
    torch.manual_seed(3)
    pm = _randomize_bn(PMel.Melception(num_classes=9, features_list=TAPS), 4).eval()
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = apply(convert_melception(sd, template), jnp.asarray(mel))
    with torch.no_grad():
        got = pm(torch.from_numpy(mel))
    for k in TAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_released_checkpoint_loads_strict(tmp_path):
    """A released file's layout: ``{"model": state_dict}`` with torchvision's
    auxiliary head beside it; a name that does not fit raises."""
    torch.manual_seed(0)
    src = _randomize_bn(PMel.Melception(num_classes=5), 1)
    sd = dict(src.state_dict(), **{"AuxLogits.fc.weight": torch.zeros(5, 768),
                                   "AuxLogits.fc.bias": torch.zeros(5)})
    torch.save({"model": sd, "epoch": 3}, tmp_path / "melception.pt")
    dst = PMel.load_melception_checkpoint(PMel.Melception(num_classes=5), str(tmp_path / "melception.pt"))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    torch.save({"model": dict(sd, **{"Mixed_5b.extra.weight": torch.zeros(1)})}, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        PMel.load_melception_checkpoint(PMel.Melception(num_classes=5), str(tmp_path / "bad.pt"))


def test_melception_registered_under_the_jax_names():
    from text_to_sound_synthesis_torch.utils.config import instantiate_from_config

    for target in ("text_to_sound_synthesis_tpu.models.melception.Melception",
                   "evaluation.feature_extractors.melception.Melception"):
        with torch.device("meta"):
            m = instantiate_from_config({"target": target, "params": {"num_classes": 7}})
        assert isinstance(m, PMel.Melception) and m.fc.out_features == 7


# ---------------------------------------------------------------------------
# extract_features / evaluate_folders
# ---------------------------------------------------------------------------

SMALL = (24, 32)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    gen, ref = root / "gen", root / "ref"
    gen.mkdir()
    ref.mkdir()
    rng = np.random.default_rng(6)
    for i in range(4):
        base = rng.random(SMALL).astype(np.float32)
        np.save(ref / f"clip{i}_mel.npy", base)
        for s in range(2):
            np.save(gen / f"clip{i}_sample_{s}.npy",
                    np.clip(base + 0.2 * rng.standard_normal(SMALL), 0, 1).astype(np.float32))
    jm = JMM.Melception(num_classes=9)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,) + SMALL)), 2)
    pm = from_jax.load_melception(PMel.Melception(num_classes=9), params)
    stats = rng.uniform(0.2, 0.6, SMALL[0]).astype(np.float32), \
        rng.uniform(0.5, 1.5, SMALL[0]).astype(np.float32)
    return str(gen), str(ref), jm, params, pm, stats


def test_extract_features_matches_jax(folders):
    gen, _, jm, params, pm, (means, stds) = folders
    kw = dict(batch_size=3, means=means, stds=stds, crop_len=30)
    want = JF.extract_features(jm, params, JF.FakesFolder(gen), **kw)
    got = PF.extract_features(pm, PF.FakesFolder(gen), **kw)
    assert got["file_path_"] == want["file_path_"] and len(got["file_path_"]) == 8
    assert sorted(got) == sorted(want)
    for k in ("2048", "logits", "logits_unbiased"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    # one forward per batch, the last one short: the same rows as one batch of all
    whole = PF.extract_features(pm, PF.FakesFolder(gen), **dict(kw, batch_size=8))
    for k in ("2048", "logits"):
        np.testing.assert_allclose(got[k], whole[k], rtol=0, atol=1e-6)


def test_evaluate_folders_matches_jax(folders):
    gen, ref, jm, params, pm, _ = folders
    want = JF.evaluate_folders(jm, params, gen, ref, batch_size=3, kid_subset_size=4)
    got = PF.evaluate_folders(pm, gen, ref, batch_size=3, kid_subset_size=4)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert np.isfinite(v), k
        tol = 1e-4 if k == "frechet_inception_distance" else 1e-6
        assert abs(v - want[k]) <= tol * max(1.0, abs(want[k])), (k, v, want[k])
