"""Text codec: caption strings -> padded token ids + mask.

Parity target: ``Tokenize``
(``Diffsound/sound_synthesis/modeling/codecs/text_codec/tokenize.py:7-80``) and
the batch packing of ``clip.py:tokenize`` (pad to context_length with
``pad_value``, boolean mask, over-length truncation that preserves the final
EOT token).

Copy of ``text_to_sound_synthesis_tpu/models/clip/tokenize.py`` with one
difference: the BPE tokenizer is built at the first ``get_tokens`` call, not
in ``__init__``, so a model builds where the merge table is absent and the
caller hands it BPE ids directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from ...utils.config import instantiate_from_config, register
from .tokenizer import ClipBPETokenizer

__all__ = ["Tokenize"]


@register(
    "text_to_sound_synthesis_tpu.models.clip.Tokenize",
    "sound_synthesis.modeling.codecs.text_codec.tokenize.Tokenize",
)
class Tokenize:
    def __init__(
        self,
        context_length: int = 77,
        add_start_and_end: bool = True,
        just_token: bool = False,
        with_mask: bool = True,
        pad_value: int = 0,
        clip_embedding: bool = False,
        condition_emb_config: Optional[Mapping[str, Any]] = None,
        tokenizer_config: Optional[Mapping[str, Any]] = None,
    ):
        self.context_length = context_length
        self.add_start_and_end = add_start_and_end
        self.just_token = just_token
        self.with_mask = with_mask
        self.pad_value = pad_value
        if clip_embedding:
            raise NotImplementedError(
                "precomputed clip_embedding mode: embed tokens with CLIPTextEmbedding "
                "in the model instead (frozen tower runs on-device here)"
            )
        self.tokenizer_config = tokenizer_config
        self._tokenizer = None

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            if self.tokenizer_config is not None:
                self._tokenizer = instantiate_from_config(self.tokenizer_config)
            else:
                self._tokenizer = ClipBPETokenizer()
        return self._tokenizer

    def get_tokens(self, text: Union[str, Sequence[str]]) -> Dict[str, np.ndarray]:
        if isinstance(text, str):
            text = [text]
        sot = [self.tokenizer.sot_id] if self.add_start_and_end else []
        eot = [self.tokenizer.eot_id] if self.add_start_and_end else []
        all_tokens: List[List[int]] = [
            sot + self.tokenizer.encode(t.lower()) + eot for t in text
        ]
        if self.just_token:
            return {"token": all_tokens}

        n, L = len(all_tokens), self.context_length
        ids = np.full((n, L), self.pad_value, dtype=np.int32)
        mask = np.zeros((n, L), dtype=bool)
        for i, toks in enumerate(all_tokens):
            if len(toks) > L:
                last = toks[-1]
                toks = toks[:L]
                toks[-1] = last  # keep EOT at the boundary
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = True
        out = {"token": ids}
        if self.with_mask:
            out["mask"] = mask
        return out


# register the tokenizer itself under its reference target
from ...utils.config import GLOBAL_REGISTRY  # noqa: E402

GLOBAL_REGISTRY.register(
    "text_to_sound_synthesis_tpu.models.clip.ClipBPETokenizer",
    "sound_synthesis.modeling.modules.clip.simple_tokenizer.SimpleTokenizer",
)(ClipBPETokenizer)
