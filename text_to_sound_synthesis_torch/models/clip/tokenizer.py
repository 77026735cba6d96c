"""CLIP byte-BPE tokenizer (pure Python, no torch/ftfy).

Behavior parity with the vendored tokenizer the reference uses
(``Diffsound/sound_synthesis/modeling/modules/clip/simple_tokenizer.py`` and the
``tokenize()`` entry at ``clip.py:164-218``): same vocab construction (byte
alphabet + ``</w>`` variants + ``end_idx-256-2`` merges + SOT/EOT), same merge
procedure, same lowercase/whitespace cleanup, same pad/truncate-with-EOT rule.

The merge table ``bpe_simple_vocab_16e6.txt.gz`` is an external artifact (like
the released model checkpoints): point ``bpe_path`` at it, set ``$T2S_CLIP_BPE``,
or drop it under ``<repo>/artifacts/``. ftfy's mojibake fixing is skipped (the
AudioCaps captions are plain ASCII); HTML-unescape and whitespace folding match.
Words are split as the reference's ``regex`` pattern splits them, letters and
numbers of every script included, by ``word_split.split_words`` on the
standard library alone.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

from .word_split import split_words

__all__ = ["ClipBPETokenizer", "find_default_bpe", "byte_unicode_table"]

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


def find_default_bpe() -> str:
    """Locate the merge table artifact: $T2S_CLIP_BPE, then <repo>/artifacts/."""
    candidates = [os.environ.get("T2S_CLIP_BPE", "")]
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.abspath(os.path.join(here, "..", "..", ".."))
    for base in (repo, here):
        candidates.append(os.path.join(base, "artifacts", "bpe_simple_vocab_16e6.txt.gz"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(
        "CLIP BPE merge table not found. Set $T2S_CLIP_BPE or place "
        "bpe_simple_vocab_16e6.txt.gz under <repo>/artifacts/ "
        "(released with OpenAI CLIP)."
    )


@lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (the GPT-2/CLIP convention):
    printable latin-1 bytes map to themselves; the rest to U+0100.. in order.

    Insertion order matters: printable bytes first, then the remapped ones —
    the BPE vocab is built from ``values()`` and token ids must line up with
    the released CLIP vocabulary.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    table = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def _adjacent_pairs(symbols: Sequence[str]) -> set:
    return {(symbols[i], symbols[i + 1]) for i in range(len(symbols) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class ClipBPETokenizer:
    """Byte-level BPE with CLIP's end-of-word convention.

    ``end_idx`` bounds how many merges are loaded: 49152 for CLIP,
    16384 for DALL-E (matching the reference's ``SimpleTokenizer(end_idx=...)``).
    """

    def __init__(self, end_idx: int = 49152, bpe_path: str | None = None):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        path = bpe_path or find_default_bpe()
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        n_merges = end_idx - 256 - 2
        merges: List[Tuple[str, str]] = [
            tuple(line.split()) for line in lines[1 : n_merges + 1]
        ]

        alphabet = list(self.byte_encoder.values())
        vocab = alphabet + [ch + "</w>" for ch in alphabet]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        if len(symbols) == 1:
            return token + "</w>"
        while len(symbols) > 1:
            pairs = _adjacent_pairs(symbols)
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and symbols[i] == first
                    and symbols[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        out = " ".join(symbols)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for word in split_words(text):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[ch] for ch in text if ch in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")
