"""Caption metrics: BLEU-1..4, ROUGE-L, CIDEr-D, METEOR-lite, SPIDEr.

The port's own copy of ``text_to_sound_synthesis_tpu/evaluation/caption_metrics.py``
(numpy only), with ``resolution()`` added: which stemmer and which synonym
table METEOR uses on this host (a host without nltk, as the card's, takes
the lite stemmer and the vendored table, and its METEOR differs).

Parity target: the metric set of ``Codebook/AudiocaptionLoss/eval_metrics.py:243-249``
(coco-caption wrappers). Pure-Python reimplementations of the standard
definitions:

* BLEU-n: corpus-level modified n-gram precision with brevity penalty and the
  closest-reference-length convention;
* ROUGE-L: LCS-based F-beta (beta = 1.2), max over references;
* CIDEr-D: tf-idf weighted cosine over 1..4-grams, length-gaussian penalty
  (sigma = 6), average over references, x10;
* METEOR: stage-wise unigram alignment — exact, then Porter-stem, then
  synonym. The synonym stage uses a real WordNet corpus when one is installed
  for nltk; a host without one (or without nltk) falls back to a vendored
  compact synonym table curated for the audio-caption domain
  (``evaluation/synonyms.py``; override with $T2S_SYNONYMS; pass
  ``synonyms="none"`` to disable the stage). Alignment is the jar's search:
  per stage, a MAXIMUM matching with the minimum-chunk alignment among
  maximum matchings, resolved — as in the jar itself
  (meteor-1.5 uses a width-40 beam) — by a beam search (width 256 here;
  agrees with an exhaustive oracle on the pinned probe set,
  tests/test_caption_metrics_full.py).
  Corpus score = mean of segment scores (the jar aggregates match statistics
  before scoring; a small documented delta). Parameters are coco-caption's
  (alpha=0.9, beta=3, gamma=0.5).
* METEOR-lite: the round-1 exact-match-only variant, kept for continuity and
  reported as ``meteor_lite``. On a morphology-heavy 40-pair audio-caption
  probe set it reads ~0.39 (absolute) below the stemmed METEOR
  (tests/test_caption_metrics_full.py); on real caption sets the gap lands
  between 0 (exact-match outputs) and that bound. Prefer ``meteor``.
* SPICE requires the Java scene-graph parser and is not reimplemented; SPIDEr
  here is (CIDEr + SPICE)/2 when SPICE scores are supplied externally, else
  reported as ``spider_cider_only`` = CIDEr-based fallback (documented,
  NOT the paper's SPIDEr).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["tokenize_caption", "bleu", "rouge_l", "cider_d", "meteor",
           "meteor_lite", "caption_scores", "resolution"]


def tokenize_caption(text: str) -> List[str]:
    """PTB-ish lowercase word tokenization (coco-caption convention, simplified)."""
    import re

    text = text.lower()
    text = re.sub(r"[^a-z0-9' ]+", " ", text)
    return text.split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def bleu(candidates: Sequence[Sequence[str]], references: Sequence[Sequence[Sequence[str]]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n. candidates[i] is a token list; references[i] a list
    of token lists."""
    p_num = np.zeros(max_n)
    p_den = np.zeros(max_n)
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cg = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                rg = _ngrams(r, n)
                for g, c in rg.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped = sum(min(c, max_ref[g]) for g, c in cg.items())
            p_num[n - 1] += clipped
            p_den[n - 1] += max(sum(cg.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    log_sum = 0.0
    for n in range(max_n):
        p = p_num[n] / p_den[n] if p_den[n] > 0 else 0.0
        log_sum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(candidates, references, beta: float = 1.2) -> float:
    scores = []
    for cand, refs in zip(candidates, references):
        best = 0.0
        for r in refs:
            l = _lcs(cand, r)
            if l == 0:
                continue
            prec = l / len(cand)
            rec = l / len(r)
            best = max(best, (1 + beta**2) * prec * rec / (rec + beta**2 * prec))
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider_d(candidates, references, max_n: int = 4, sigma: float = 6.0) -> float:
    # document frequency over reference sets
    df: List[Counter] = [Counter() for _ in range(max_n)]
    for refs in references:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen |= set(_ngrams(r, n).keys())
            for g in seen:
                df[n - 1][g] += 1
    n_docs = max(len(references), 1)

    def tfidf_vec(tokens, n):
        counts = _ngrams(tokens, n)
        total = max(sum(counts.values()), 1)
        vec = {}
        for g, c in counts.items():
            idf = math.log(max(n_docs, 1)) - math.log(max(df[n - 1][g], 1))
            vec[g] = (c / total) * idf
        return vec

    def cos(v1, v2, len1, len2):
        num = sum(min(v1.get(g, 0.0), v2.get(g, 0.0)) * v2.get(g, 0.0)
                  for g in v1)  # CIDEr-D clips candidate counts
        norm1 = math.sqrt(sum(x * x for x in v1.values()))
        norm2 = math.sqrt(sum(x * x for x in v2.values()))
        if norm1 == 0 or norm2 == 0:
            return 0.0
        val = num / (norm1 * norm2)
        delta = len1 - len2
        return val * math.exp(-(delta**2) / (2 * sigma**2))

    scores = []
    for cand, refs in zip(candidates, references):
        s = 0.0
        for n in range(1, max_n + 1):
            vc = tfidf_vec(cand, n)
            per_ref = [cos(vc, tfidf_vec(r, n), len(cand), len(r)) for r in refs]
            s += np.mean(per_ref) if per_ref else 0.0
        scores.append(10.0 * s / max_n)
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# METEOR-lite
# ---------------------------------------------------------------------------

def meteor_lite(candidates, references, alpha: float = 0.9, beta_: float = 3.0,
                gamma: float = 0.5) -> float:
    scores = []
    for cand, refs in zip(candidates, references):
        best = 0.0
        for r in refs:
            matches = 0
            chunks = 0
            used = [False] * len(r)
            prev_j = -2
            for tok in cand:
                for j, rt in enumerate(r):
                    if not used[j] and rt == tok:
                        used[j] = True
                        matches += 1
                        if j != prev_j + 1:
                            chunks += 1
                        prev_j = j
                        break
            if matches == 0:
                continue
            prec = matches / len(cand)
            rec = matches / len(r)
            fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            frag = chunks / matches
            score = fmean * (1 - gamma * frag**beta_)
            best = max(best, score)
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# METEOR (exact + stem + optional WordNet synonyms)
# ---------------------------------------------------------------------------

def _porter():
    try:
        from nltk.stem import PorterStemmer

        return PorterStemmer().stem
    except Exception:  # minimal fallback: crude suffix stripping
        def lite(w: str) -> str:
            for s in ("ing", "ed", "es", "s"):
                if w.endswith(s) and len(w) > len(s) + 2:
                    return w[: -len(s)]
            return w

        return lite


def _wordnet_synsets():
    """word -> frozenset(synonyms) lookup for the METEOR synonym stage.

    Prefers a real nltk WordNet corpus when one is installed (drop it into an
    ``nltk_data`` directory); otherwise falls back to the vendored compact
    synonym table (``evaluation/synonyms.py``, override via $T2S_SYNONYMS) so
    the stage always has a live, tested execution path."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("dog")  # force the lazy corpus load / raise

        def lookup(word: str) -> frozenset:
            names = set()
            for syn in wordnet.synsets(word):
                for lemma in syn.lemma_names():
                    names.add(lemma.lower())
            return frozenset(names)

        return lookup
    except Exception:
        from .synonyms import synonym_lookup

        return synonym_lookup


def resolution() -> Dict[str, str]:
    """Which stemmer and which synonym table ``meteor`` uses on this host
    (``_porter``'s and ``_wordnet_synsets``'s choices): {"stemmer": "nltk
    porter" | "lite", "synonyms": "nltk wordnet" | "$T2S_SYNONYMS=<path>" |
    "vendored"}."""
    import os

    from .synonyms import synonym_lookup

    stemmer = "lite" if _porter().__name__ == "lite" else "nltk porter"
    if _wordnet_synsets() is not synonym_lookup:
        synonyms = "nltk wordnet"
    else:
        path = os.environ.get("T2S_SYNONYMS")
        synonyms = f"$T2S_SYNONYMS={path}" if path else "vendored"
    return {"stemmer": stemmer, "synonyms": synonyms}


def _align(cand: Sequence[str], ref: Sequence[str], stages,
           beam: int = 256) -> List[tuple]:
    """Stage-wise unigram alignment following the METEOR search (the Java
    jar's semantics, ``AudiocaptionLoss/eval_metrics.py:243-249`` toolchain):
    each stage is ``match(ci, rj) -> bool``; within a stage the aligner takes
    a maximum matching over still-unaligned tokens and, among maximum
    matchings, the one minimizing the chunk count of the cumulative
    alignment. Like the jar (meteor-1.5's aligner resolves this with a
    beam search, width 40), the search here is a beam over candidate tokens
    — width 256, so at-least-as-exhaustive as the jar; it agrees with an
    exhaustive oracle on the pinned probe set
    (tests/test_caption_metrics_full.py) but, like the jar, can in principle
    return a sub-optimal alignment for pathologically match-dense inputs
    whose partial-state count exceeds the beam. Returns
    [(cand_idx, ref_idx)] sorted by cand_idx."""
    import heapq

    pairs: Dict[int, int] = {}
    used: set = set()
    for match in stages:
        free_i = [i for i in range(len(cand)) if i not in pairs]
        opts = {i: [j for j in range(len(ref))
                    if j not in used and match(cand[i], ref[j])]
                for i in free_i}
        fixed = sorted(pairs.items())

        def score(assign):
            # maximize matches, then minimize chunks of the cumulative pairing
            return (-len(assign), _chunks(sorted(fixed + list(assign))))

        # beam over candidate tokens in order; state = (score, assign, used_j)
        # — the score is computed once per state, not per sort comparison
        states = [(score(()), (), frozenset())]
        for i in free_i:
            if not opts[i]:
                continue
            nxt = list(states)  # leaving token i unmatched keeps the state
            for sc, assign, usedj in states:
                for j in opts[i]:
                    if j not in usedj:
                        a = assign + ((i, j),)
                        nxt.append((score(a), a, usedj | {j}))
            states = heapq.nsmallest(beam, nxt, key=lambda st: st[0])
        best = min(states, key=lambda st: st[0])[1]
        for i, j in best:
            pairs[i] = j
            used.add(j)
    return sorted(pairs.items())


def _chunks(pairs: List[tuple]) -> int:
    ch = 0
    prev = (-2, -2)
    for i, j in pairs:
        if i != prev[0] + 1 or j != prev[1] + 1:
            ch += 1
        prev = (i, j)
    return ch


def meteor(candidates, references, alpha: float = 0.9, beta_: float = 3.0,
           gamma: float = 0.5, synonyms="auto") -> float:
    """METEOR with exact -> Porter-stem -> synonym stages (see module
    docstring for the synonym-table resolution). ``synonyms``: "auto"
    (WordNet, else the vendored table), "none" (exact+stem only), or a
    ``word -> frozenset`` callable. Segment score = best reference; corpus
    score = mean of segments."""
    from functools import lru_cache

    # memoized per token: _align probes stem/synsets O(|cand| x |ref|) times
    # per stage per reference, but the token vocabulary is tiny
    stem = lru_cache(maxsize=None)(_porter())
    syn0 = (_wordnet_synsets() if synonyms == "auto"
            else None if synonyms == "none" else synonyms)
    stages = [lambda c, r: c == r,
              lambda c, r: stem(c) == stem(r)]
    if syn0 is not None:
        syn = lru_cache(maxsize=None)(syn0)
        stages.append(lambda c, r: c in syn(r) or r in syn(c))

    scores = []
    for cand, refs in zip(candidates, references):
        best = 0.0
        for r in refs:
            if not cand or not r:
                continue
            pairs = _align(cand, r, stages)
            m = len(pairs)
            if m == 0:
                continue
            prec = m / len(cand)
            rec = m / len(r)
            fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            frag = _chunks(pairs) / m
            best = max(best, fmean * (1 - gamma * frag**beta_))
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def caption_scores(
    candidates_text: Sequence[str],
    references_text: Sequence[Sequence[str]],
    spice_scores: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """All metrics over raw strings (eval_metrics.evaluate_metrics equivalent)."""
    cands = [tokenize_caption(c) for c in candidates_text]
    refs = [[tokenize_caption(r) for r in rs] for rs in references_text]
    b = bleu(cands, refs)
    out = {f"bleu_{i+1}": b[i] for i in range(4)}
    out["rouge_l"] = rouge_l(cands, refs)
    out["cider"] = cider_d(cands, refs)
    out["meteor"] = meteor(cands, refs)
    out["meteor_lite"] = meteor_lite(cands, refs)
    if spice_scores is not None:
        out["spice"] = float(np.mean(spice_scores))
        out["spider"] = 0.5 * (out["cider"] + out["spice"])
    else:
        out["spider_cider_only"] = out["cider"]
    return out
