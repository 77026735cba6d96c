"""The port's CLIP tokenizer against the JAX package's, which splits words
with ``regex`` here.

The port splits words on the standard library alone
(``models/clip/word_split.py``): its character tables are rebuilt here from
the installed ``regex`` and held equal, and its splits, BPE ids and
``Tokenize.get_tokens`` are held to the JAX package's on fixed captions and
on arbitrary text. The merge table is ``chip_smoke.py``'s synthetic one,
written to ``tmp_path``: the released table is not in the repository.
"""

import os
import re
import sys

import numpy as np
import pytest
import regex
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from text_to_sound_synthesis_torch.models.clip import tokenize as port_tokenize  # noqa: E402
from text_to_sound_synthesis_torch.models.clip import word_split  # noqa: E402
from text_to_sound_synthesis_torch.models.clip.tokenizer import (  # noqa: E402
    ClipBPETokenizer as PortTokenizer)
from text_to_sound_synthesis_tpu.models.clip import tokenize as jax_tokenize  # noqa: E402
from text_to_sound_synthesis_tpu.models.clip import tokenizer as jax_tokenizer  # noqa: E402

# the reference's pattern, compiled here with ``regex`` (the JAX package's)
PATTERN = regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    regex.IGNORECASE)

CAPTIONS = list(chip_smoke.TOKENIZER_IDS) + [
    "a café with naïve jazz",
    "  rain \t\n falls   on a  tin roof  ",
    "&lt;b&gt;thunder&lt;/b&gt; &amp;&amp; &quot;wind&quot; &#x27;loud&#x27; &eacute;",
    "<|startoftext|>the dog<|endoftext|> <|STARTOFTEXT|> !!<|endoftext|>",
    "'S 'T 'RE 'Ve 'm 'LL 'd 'ſun x'y ''s",
    "xͅy ͅ Ᲊ \U00010940 \U00011db0 ⅠⅡ ²³",
    "\x1c\x1d\x1e\x1f\x85\xa0      　​",
    " ".join(["a long caption of many short words"] * 12),   # over 77 tokens
]


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return chip_smoke.write_merge_table(str(tmp_path_factory.mktemp("bpe") / "merges.txt"))


def _ranges(chars):
    out = []
    for c in sorted(ord(ch) for ch in chars):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [tuple(r) for r in out]


def _table(ranges):
    return list(zip(*ranges))


def test_tables_equal_regex():
    """The port's letter, number and skip tables are ``regex``'s classes
    under IGNORECASE over every code point; the characters that match the
    pattern's ASCII characters under IGNORECASE are those ``folds_to`` takes."""
    every = "".join(chr(c) for c in range(0x110000))
    letters = set(regex.findall(r"[\p{L}]", every, regex.IGNORECASE))
    numbers = set(regex.findall(r"[\p{N}]", every, regex.IGNORECASE))
    rest = set(regex.findall(r"[^\s\p{L}\p{N}]", every, regex.IGNORECASE))
    skip = set(every) - letters - numbers - rest
    for want, got in ((letters, word_split._LETTER_RANGES), (numbers, word_split._NUMBER_RANGES),
                      (skip, word_split._SKIP_RANGES)):
        assert [tuple(t) for t in _table(_ranges(want))] == [tuple(t) for t in got]
    assert not (letters & numbers or letters & rest or numbers & rest)
    for ch in set("<|startoftext|>endoftext'streveml"):
        want = set(regex.findall(regex.escape(ch), every, regex.IGNORECASE))
        candidates = {ch, ch.upper(), *word_split._FOLD}
        assert want == {c for c in candidates if word_split.folds_to(c, ch)}, ch


def _encode(tokenizer, text):
    """The ids, or the error's type where the text has no UTF-8 form (a
    lone surrogate): both tokenizers must raise it."""
    try:
        return tokenizer.encode(text)
    except UnicodeEncodeError as e:
        return type(e)


def test_split_fixed_captions(bpe_path):
    """``split_words`` is ``regex``'s findall, and the port's BPE ids are the
    JAX package's, on ASCII and non-ASCII captions."""
    port, ref = PortTokenizer(bpe_path=bpe_path), jax_tokenizer.ClipBPETokenizer(bpe_path=bpe_path)
    assert jax_tokenizer._WORD_PAT.pattern == PATTERN.pattern   # the JAX package runs regex here
    for cap in CAPTIONS:
        for text in (cap, cap.lower(), jax_tokenizer._clean(cap).lower()):
            assert word_split.split_words(text) == PATTERN.findall(text), repr(text)
        assert _encode(port, cap) == _encode(ref, cap), repr(cap)
    lone = "a \ud83d surrogate"               # no UTF-8 form: both raise
    assert word_split.split_words(lone) == PATTERN.findall(lone)
    assert _encode(port, lone) == _encode(ref, lone) == UnicodeEncodeError
    assert (port.vocab_size, port.sot_id, port.eot_id) == (532, 530, 531)
    assert word_split.split_words("a café with naïve jazz") == [
        "a", "café", "with", "naïve", "jazz"]
    assert word_split.split_words("straße") == ["straße"]


def test_smoke_constants_are_the_jax_ids(bpe_path):
    """``chip_smoke.py`` phase 10e (a) holds the port on the card to these
    ids: they are the JAX package's on the same table."""
    ref = jax_tokenizer.ClipBPETokenizer(bpe_path=bpe_path)
    for cap, ids in chip_smoke.TOKENIZER_IDS.items():
        assert ref.encode(cap) == ids, repr(cap)


# characters of the categories drawn, and pieces of the pattern's own words
_TEXT = st.lists(
    st.one_of(
        st.characters(categories=("L", "N", "Z", "P", "S", "Cc")),
        st.sampled_from(["'", "s", "S", "t", "re", "VE", "m", "ll", "D", "ſ", "<|", "|>",
                         "<|startoftext|>", "<|endoftext|>", "ͅ", "\x1c", "\x85"])),
    max_size=40).map("".join)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=_TEXT)
def test_split_arbitrary_text(text):
    """On arbitrary text (letters, numbers, separators, punctuation, symbols
    and control characters of every script), ``split_words`` is ``regex``'s
    findall, raw and as the tokenizer cleans it."""
    assert word_split.split_words(text) == PATTERN.findall(text)
    clean = jax_tokenizer._clean(text).lower()
    assert word_split.split_words(clean) == jax_tokenizer._WORD_PAT.findall(clean)


@pytest.fixture(scope="module")
def tokenizers(bpe_path):
    return PortTokenizer(bpe_path=bpe_path), jax_tokenizer.ClipBPETokenizer(bpe_path=bpe_path)


@settings(max_examples=100, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=_TEXT)
def test_encode_arbitrary_text(tokenizers, text):
    port, ref = tokenizers
    assert port.encode(text) == ref.encode(text)


def test_ascii_fallback_disagrees():
    """The pattern the port used where ``regex`` was missing split non-ASCII
    words apart; the port's splitter does not."""
    old = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE)
    text = "a café with naïve jazz"
    assert old.findall(text) == ["a", "caf", "é", "with", "na", "ï", "ve", "jazz"]
    assert word_split.split_words(text) == PATTERN.findall(text) != old.findall(text)
    assert old.findall("straße") != word_split.split_words("straße")


def test_get_tokens(bpe_path, monkeypatch):
    """``Tokenize.get_tokens``: ids, mask, and the truncation that keeps EOT,
    equal to the JAX package's on the same table."""
    monkeypatch.setenv("T2S_CLIP_BPE", bpe_path)
    for ctx in (77, 12):
        port = port_tokenize.Tokenize(context_length=ctx).get_tokens(CAPTIONS)
        ref = jax_tokenize.Tokenize(context_length=ctx).get_tokens(CAPTIONS)
        np.testing.assert_array_equal(port["token"], ref["token"])
        np.testing.assert_array_equal(port["mask"], ref["mask"])
        assert (port["token"][:, -1] == 531).sum() >= 1      # a long caption ends in EOT
