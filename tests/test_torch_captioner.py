"""The port's ACT captioner, its caption metrics and ``tools/eval_captions``
against the JAX package.

The captioner runs at the JAX tests' TINY config (``tests/test_captioner.py``:
one 768-wide encoder block, a 16-wide decoder layer), its weights drawn with
numpy on JAX's parameter shapes (``jax.eval_shape``, no init) and carried
across by ``convert/from_jax.py::load_captioner``. Both sides run f32: logits
within atol 1e-4 (measured 1e-6), and greedy and beam tokens equal. The
caption metrics are the port's own copies of numpy code: equal to JAX's
results exactly, on this host's stemmer and synonym table.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_torch.convert.from_jax import captioner_state_dict, load_captioner
from text_to_sound_synthesis_torch.evaluation import caption_metrics as PCM
from text_to_sound_synthesis_torch.models.captioner import ACTCaptioner, beam_decode, greedy_decode
from text_to_sound_synthesis_tpu.evaluation import caption_metrics as JCM
from text_to_sound_synthesis_tpu.models import captioner as JC

torch.set_num_threads(1)

TINY = dict(ntoken=20, nhid=16, nhead=2, nlayers=1, dim_feedforward=32,
            encoder_num_classes=12, encoder_depth=1, max_len=6, sos_id=0, eos_id=9)


def _draw(shapes, seed):
    """Numpy draws on a flax tree of shapes: kernels N(0, 1/fan_in), biases
    and shifts small, norm scales near 1, embeddings and tokens N(0, 1)."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "bn0_scale"):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name in ("bias", "bn0_shift"):
            return rng.normal(0, 0.05, s.shape).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


@pytest.fixture(scope="module")
def tiny():
    jm = JC.ACTCaptioner(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                            jnp.zeros((1, 4), jnp.int32))
    params = _draw(shapes, 7)
    pm = load_captioner(ACTCaptioner(**TINY), params).eval()
    mel = np.random.default_rng(1).standard_normal((2, 16, 80)).astype(np.float32)
    return jm, params, pm, mel


def test_logits_and_memory_match_jax(tiny):
    jm, params, pm, mel = tiny
    tgt = np.random.default_rng(2).integers(0, 20, (2, 5)).astype(np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(mel), jnp.asarray(tgt)))
    mem = np.asarray(jm.apply(params, jnp.asarray(mel), method=jm.encode))
    with torch.no_grad():
        got_mem = pm.encode(torch.from_numpy(mel)).numpy()
        got = pm(torch.from_numpy(mel), torch.from_numpy(tgt)).numpy()
    assert got.shape == want.shape == (2, 5, 20) and got_mem.shape == mem.shape == (2, 5, 16)
    np.testing.assert_allclose(got_mem, mem, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_decoder_is_causal(tiny):
    _, _, pm, mel = tiny
    tgt = torch.from_numpy(np.random.default_rng(3).integers(0, 20, (1, 5)))
    tgt2 = tgt.clone()
    tgt2[:, 4] = (tgt2[:, 4] + 1) % 20
    with torch.no_grad():
        memory = pm.encode(torch.from_numpy(mel[:1]))
        a, b = pm.decode(memory, tgt), pm.decode(memory, tgt2)
    torch.testing.assert_close(a[:, :4], b[:, :4], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, 4], b[:, 4])


def test_greedy_decode_tokens_equal_jax(tiny):
    jm, params, pm, mel = tiny
    want = JC.greedy_decode(jm, params, jnp.asarray(mel))
    got = greedy_decode(pm, torch.from_numpy(mel))
    assert got.dtype == np.int32 and (got[:, 0] == 0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beam", [2, 3])
def test_beam_decode_tokens_equal_jax(tiny, beam):
    jm, params, pm, mel = tiny
    want = JC.beam_decode(jm, params, jnp.asarray(mel), beam_size=beam)
    got = beam_decode(pm, torch.from_numpy(mel), beam_size=beam)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == 0
        np.testing.assert_array_equal(g, w)


def test_default_captioner_names_and_shapes_match_jax():
    """The full default ACT (12-layer 768-wide encoder, 2-layer decoder,
    4368 words): the bridge's names and shapes are the port module's."""
    jm = JC.ACTCaptioner()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 848, 80)),
                            jnp.zeros((1, 2), jnp.int32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = captioner_state_dict(zeros)
    with torch.device("meta"):
        pm = ACTCaptioner()
    want = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "encoder.block_11.qkv.weight" in want and "dec_1.cross_out.weight" in want


# ---------------------------------------------------------------------------
# caption metrics: the port's copies against the JAX package's
# ---------------------------------------------------------------------------

CASES = {
    "perfect": (["a dog barks in the rain"], [["a dog barks in the rain"]]),
    "disjoint": (["a dog barks in the rain"],
                 [["completely different words entirely here now"]]),
    "two_clips": (["a dog barks in the rain", "a car engine revs"],
                  [["a dog barks in the rain", "dog barking during rain"],
                   ["a car engine revs", "an engine revving loudly"]]),
    "morphology": (["dogs barking while cars are passing by", "birds chirped loudly"],
                   [["a dog barks as a car passes", "dogs bark and vehicles pass"],
                    ["a bird chirps", "birds are chirping and singing loudly"]]),
    "synonyms": (["a hound yaps near the automobile", "the crowd claps"],
                 [["a dog barks near the car"], ["people applaud and cheer"]]),
}


def _tok(cands, refs):
    return ([JCM.tokenize_caption(c) for c in cands],
            [[JCM.tokenize_caption(r) for r in rs] for rs in refs])


@pytest.mark.parametrize("case", sorted(CASES))
def test_bleu_equals_jax(case):
    c, r = _tok(*CASES[case])
    assert PCM.bleu(c, r) == JCM.bleu(c, r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rouge_l_equals_jax(case):
    c, r = _tok(*CASES[case])
    assert PCM.rouge_l(c, r) == JCM.rouge_l(c, r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cider_d_equals_jax(case):
    c, r = _tok(*CASES[case])
    assert PCM.cider_d(c, r) == JCM.cider_d(c, r)


@pytest.mark.parametrize("synonyms", ["auto", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_meteor_equals_jax(case, synonyms):
    c, r = _tok(*CASES[case])
    assert PCM.meteor(c, r, synonyms=synonyms) == JCM.meteor(c, r, synonyms=synonyms)
    assert PCM.meteor_lite(c, r) == JCM.meteor_lite(c, r)


@pytest.mark.parametrize("spice", [None, [0.25, 0.5]])
@pytest.mark.parametrize("case", ["two_clips", "morphology", "synonyms"])
def test_caption_scores_equal_jax(case, spice):
    cands, refs = CASES[case]
    assert PCM.caption_scores(cands, refs, spice) == JCM.caption_scores(cands, refs, spice)


def test_synonym_table_is_the_jax_packages():
    from text_to_sound_synthesis_torch.evaluation import synonyms as PS
    from text_to_sound_synthesis_tpu.evaluation import synonyms as JS

    assert PS.SYNONYM_GROUPS == JS.SYNONYM_GROUPS
    assert PS.load_synonym_table() == JS.load_synonym_table()


def test_resolution_names_this_hosts_stemmer_and_table(monkeypatch):
    res = PCM.resolution()
    assert res["stemmer"] in ("nltk porter", "lite")
    assert res["synonyms"] in ("nltk wordnet", "vendored") or res["synonyms"].startswith("$T2S")
    if res["synonyms"] != "nltk wordnet":
        monkeypatch.setenv("T2S_SYNONYMS", "groups.txt")
        assert PCM.resolution()["synonyms"] == "$T2S_SYNONYMS=groups.txt"


# ---------------------------------------------------------------------------
# tools/eval_captions on the CPU
# ---------------------------------------------------------------------------

def test_eval_captions_tool(tiny, tmp_path, capsys):
    from text_to_sound_synthesis_torch.tools import eval_captions

    _, params, pm, _ = tiny
    vocab = [f"w{i}" for i in range(20)]
    vocab[9] = "<eos>"
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    ckpt = tmp_path / "act.pt"
    torch.save(pm.state_dict(), ckpt)
    samples = tmp_path / "samples"
    samples.mkdir()
    rng = np.random.default_rng(5)
    for clip in ("c0", "c1"):
        for s in range(2):
            np.save(samples / f"{clip}_sample_{s}.npy", rng.random((80, 16)).astype(np.float32))
    np.save(samples / "unknown_sample_0.npy", rng.random((80, 16)).astype(np.float32))
    with open(tmp_path / "refs.csv", "w", newline="") as f:
        csv.writer(f).writerows([("c0", "w1 w2 w3"), ("c0", "w4 w5"), ("c1", "w6 w7 w8")])
    model_json = json.dumps({k: v for k, v in TINY.items() if k != "ntoken"})
    spice_dir, best = tmp_path / "spice", tmp_path / "best"
    scores = eval_captions.main([
        "--samples_dir", str(samples), "--refs", str(tmp_path / "refs.csv"), "--ckpt", str(ckpt),
        "--vocab", str(tmp_path / "vocab.txt"), "--beam", "2", "--model_json", model_json,
        "--select_topk", "1", "--select_out", str(best), "--emit_spice_input", str(spice_dir),
        "--device", "cpu"])
    out = capsys.readouterr().out
    res = PCM.resolution()
    assert f"METEOR: stemmer {res['stemmer']}, synonyms {res['synonyms']}" in out
    # the tool's captions: beam search over each known clip's file, ids -> words
    files = sorted(str(p) for p in samples.glob("c*_sample_*.npy"))
    cands = []
    for path in files:
        toks = beam_decode(pm, torch.from_numpy(np.load(path).T[None].copy()), beam_size=2)[0]
        cands.append(" ".join(vocab[int(t)] for t in toks[1:] if int(t) != 9))
    refs = {"c0": ["w1 w2 w3", "w4 w5"], "c1": ["w6 w7 w8"]}
    ref_sets = [refs[os.path.basename(p).split("_sample_")[0]] for p in files]
    assert scores == JCM.caption_scores(cands, ref_sets)
    with open(spice_dir / "predictions.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["file_name"] for r in rows] == [os.path.basename(p) for p in files]
    assert [r["caption_predicted"] for r in rows] == cands
    with open(spice_dir / "references.csv") as f:
        rrows = list(csv.DictReader(f))
    assert rrows[0]["caption_reference_03"] == "w1 w2 w3"       # cycled to five columns
    # top-1 per clip by CIDEr-D of the file's caption alone, ties to the later name
    picked = []
    for clip in ("c0", "c1"):
        entries = [(JCM.cider_d([JCM.tokenize_caption(c)],
                                [[JCM.tokenize_caption(r) for r in refs[clip]]]), p)
                   for c, p in zip(cands, files) if os.path.basename(p).startswith(clip)]
        picked.append(os.path.basename(max(entries)[1]))
    assert sorted(os.listdir(best)) == picked
