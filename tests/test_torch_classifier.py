"""The port's classifier training (``engine/classifier_solver.py``,
``tools/train_classifier.py``, ``VGGishish(use_bn=...)``) against the JAX
package's, on the CPU, the same numpy inputs and the JAX init bridged by
``convert.from_jax``.

Tolerances: the weighted cross entropy within 1e-6; the metrics equal
(float64 numpy on both sides, the same code); a step's loss within rtol
1e-5, the weights and BatchNorm statistics after it within 1e-5, except
where a gradient is zero in exact arithmetic (below 1e-6 of the largest in
the port's step: a conv's bias ahead of a BatchNorm, which subtracts it
again), where AdamW steps each side by its own rounding, held to 2 lr.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from text_to_sound_synthesis_tpu.engine import classifier_solver as jcs
from text_to_sound_synthesis_tpu.models.lpaps.vggishish import VGGishish as JVGGishish
from text_to_sound_synthesis_tpu.models.melception import Melception as JMelception
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.engine import classifier_solver as tcs
from text_to_sound_synthesis_torch.models.lpaps.vggishish import VGGishish
from text_to_sound_synthesis_torch.models.melception import Melception
from text_to_sound_synthesis_torch.tools import train_classifier

torch.set_num_threads(1)

LAYERS = (8, "MP", 16)
LR, WD = 1e-3, 1e-4


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    targets = rng.integers(0, 5, 6)
    w = rng.uniform(0.5, 3, 5).astype(np.float32)
    for weights in (None, w):
        want = float(jcs.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                                None if weights is None else jnp.asarray(weights)))
        got = float(tcs.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                               None if weights is None
                                               else torch.from_numpy(weights)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_classification_metrics_equal_jax_ties_included():
    """Rows repeat (tied probabilities across samples) and a class never
    appears (left out of mAP / mROCAUC), as the average-rank AUC must handle."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((4, 6))
    logits = np.concatenate([base, base, base[:2]])             # 10 rows, ties
    targets = np.array([0, 1, 2, 3, 0, 1, 2, 3, 1, 0])          # classes 4, 5 absent
    for topk in ((1, 5), (1, 2, 3)):
        assert (tcs.classification_metrics(targets, logits, topk)
                == jcs.classification_metrics(targets, logits, topk))
    assert tcs._roc_auc(np.array([1., 0, 1, 0]), np.array([.5, .5, .5, .5])) == 0.5


def _jax_step(model, variables, mel, target, weights):
    tx = optax.adamw(LR, weight_decay=WD)
    step = jcs.make_classifier_train_step(model, tx, class_weights=weights, donate=False)
    state, m = step(jcs.ClassifierTrainState.create(variables, tx), jnp.asarray(mel),
                    jnp.asarray(target))
    return jax.tree_util.tree_map(np.asarray, state.variables), m


def _port_step(model, mel, target, weights):
    state = tcs.ClassifierTrainState.create(model, LR, WD)
    m = tcs.make_classifier_train_step(weights)(state, torch.from_numpy(mel),
                                                torch.from_numpy(target))
    g_max = max(float(p.grad.abs().max()) for p in model.parameters())
    tiny = {k: (p.grad.abs() < 1e-6 * g_max).numpy() for k, p in model.named_parameters()}
    return m, tiny


def _assert_weights_close(model, want_sd, tiny):
    got = model.state_dict()
    assert sorted(got) == sorted(want_sd)
    for k, w in want_sd.items():
        g = got[k].numpy()
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(g - w)
        mask = tiny.get(k, np.zeros(d.shape, bool))
        assert (d[~mask] <= 1e-5).all(), (k, float(d[~mask].max()))
        assert (d <= 2 * LR).all(), k


@pytest.mark.parametrize("use_bn", [False, True])
def test_vggishish_step_matches_jax(use_bn):
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((4, 16, 24)).astype(np.float32)
    target = np.array([0, 2, 1, 2])
    weights = np.array([1.0, 2.0, 0.5], np.float32)
    jm = JVGGishish(conv_layers=LAYERS, use_bn=use_bn, num_classes=3)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 24))))
    variables = dict(variables, params=jax.tree_util.tree_map(   # nonzero biases
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"]))
    model = from_jax.load_vggishish(VGGishish(LAYERS, use_bn=use_bn, num_classes=3), variables,
                                    LAYERS, use_bn)
    new_vars, jm_metrics = _jax_step(jm, variables, mel, target, jnp.asarray(weights))
    m, tiny = _port_step(model, mel, target, torch.from_numpy(weights))
    np.testing.assert_allclose(float(m["loss"]), float(jm_metrics["loss"]), rtol=1e-5)
    assert float(m["accuracy"]) == float(jm_metrics["accuracy"])
    want = from_jax.vggishish_state_dict(new_vars, LAYERS, use_bn)
    if use_bn:       # the running statistics moved, flax's momentum 0.99
        assert not np.allclose(want["features.1.running_mean"], 0)
    _assert_weights_close(model, want, tiny)


def test_melception_step_trains_the_folded_affine():
    """Melception's BatchNorms stay in eval mode in the step: their running
    statistics keep 0 and 1 - eps, and their weight / bias move as JAX's
    ``bn_scale`` / ``bn_shift`` (at 24 x 32: 16 rows leave Mixed_7a empty)."""
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 24, 32)).astype(np.float32)
    target = np.array([1, 3])
    jm = JMelception(num_classes=5, features_list=("logits",))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 24, 32)))

    def draw(path, s):     # convs and fc ~ N(0, 1 / fan_in); BN scale ~ 1, shift ~ 0
        name = path[-1].key
        if name in ("kernel", "fc_kernel"):
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            w = (name == "bn_scale") + 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = Melception(num_classes=5, features_list=("logits",))
    from_jax.load_melception(model, params)

    class Logits:     # the JAX tool's adapter: Melception's feature dict -> its logits
        def apply(self, variables, x, **kw):
            return jm.apply(variables, x, **kw)["logits"]

    new_vars, jm_metrics = _jax_step(Logits(), params, mel, target, None)
    bn_before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    m, tiny = _port_step(model, mel, target, None)
    np.testing.assert_allclose(float(m["loss"]), float(jm_metrics["loss"]), rtol=1e-5)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, bn_before[k]), k
    assert not model.Conv2d_1a_3x3.bn.training and model.training
    _assert_weights_close(model, from_jax.melception_state_dict(new_vars), tiny)


def _specs(tmp_path, rng, n_cls=2, n_per=4, mel=16, frames=40):
    for c in range(n_cls):
        d = tmp_path / "feats" / f"cls{c}"
        d.mkdir(parents=True)
        for i in range(n_per):
            np.save(d / f"v{i}_mel.npy", rng.random((mel, frames)).astype(np.float32))
    return str(tmp_path / "feats" / "*")


def test_train_classifier_cli_smoke(tmp_path):
    """The CLI, as ``tests/test_cli.py::test_train_classifier_cli_smoke``
    runs JAX's: weighted-CE steps, validation metrics, the ``best`` and
    ``last`` checkpoints, here single files that load back."""
    spec_wc = _specs(tmp_path, np.random.default_rng(0))
    out = tmp_path / "out"
    argv = ["--arch", "vggishish", "--spec_dir", spec_wc, "--num_classes", "2",
            "--mel_num", "16", "--crop_len", "24", "--batch_size", "2", "--epochs", "1",
            "--conv_layers", "8,MP,16", "--out", str(out), "--device", "cpu"]
    assert train_classifier.main(argv) == 0
    ckpt = out / "vggishish" / "checkpoint"
    assert sorted(os.listdir(ckpt)) == ["best.pth", "last.pth"]
    payload = torch.load(ckpt / "last.pth", weights_only=False)
    assert payload["epoch"] == 0 and "accuracy_1" in payload
    VGGishish(LAYERS, num_classes=2).load_state_dict(payload["model"])


def test_train_classifier_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        train_classifier.main(["--spec_dir", "unused"])
