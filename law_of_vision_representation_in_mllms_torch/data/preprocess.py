"""Tokenization and label masking (counterpart of the JAX package's
`data/preprocess.py`).

- `SimpleTokenizer`: the dependency-free whitespace tokenizer with
  hash-bucketed ids used in tests and smoke runs. Its ids come from Python's
  `hash`, so they agree between the two packages within one process.
- `tokenizer_image_token`: split on '<image>', tokenize chunks, splice the
  IMAGE_TOKEN_INDEX (-200) sentinel (`llava/mm_utils.py:41-58`);
- `preprocess_sources`: one conversation -> (input_ids, labels) through the
  template's segment contract; only target segments keep labels, the rest is
  IGNORE_INDEX (the reference's per-template masking, `train.py:268-652`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.splice import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from .conversation import IMAGE_PLACEHOLDER, Conversation


class SimpleTokenizer:
    """Whitespace-splitting toy tokenizer (hash-bucketed ids)."""

    def __init__(self, vocab_size: int = 1000, bos: int = 1, eos: int = 2):
        self.vocab_size = vocab_size
        self.bos_token_id = bos
        self.eos_token_id = eos
        self.model_max_length = 2048

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> List[int]:
        ids = [3 + (hash(w) % (self.vocab_size - 3))
               for w in text.split()]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"t{i}" for i in ids)


def _encode(tokenizer, text: str, add_special_tokens: bool = False):
    return list(tokenizer.encode(text,
                                 add_special_tokens=add_special_tokens))


def tokenizer_image_token(prompt: str, tokenizer,
                          add_bos: bool = True) -> List[int]:
    """'<image>'-aware tokenization: chunks tokenized independently with the
    -200 sentinel between them (`mm_utils.py:41-58`)."""
    chunks = prompt.split(IMAGE_PLACEHOLDER)
    ids: List[int] = []
    if add_bos and tokenizer.bos_token_id is not None:
        ids.append(tokenizer.bos_token_id)
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(IMAGE_TOKEN_INDEX)
        ids.extend(_encode(tokenizer, chunk))
    return ids


def preprocess_sources(source: Sequence[Dict], template: Conversation,
                       tokenizer, *, has_image: bool = True,
                       max_length: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One conversation (list of {'from': human|gpt, 'value': text}) ->
    (input_ids, labels) int32 arrays.

    `preprocess_multimodal` normalization (`train.py:327-348`): '<image>'
    moves to the front of its turn, on its own line. The `plain` template
    (stage 1) keeps only '<image>' as the human segment (`train.py:588-591`).
    """
    turns: List[Tuple[str, str]] = []
    for s in source:
        text = s["value"]
        if IMAGE_PLACEHOLDER in text:
            text = text.replace(IMAGE_PLACEHOLDER, "").strip()
            text = (IMAGE_PLACEHOLDER + "\n" + text).strip()
        turns.append((s["from"], text))
    if turns and turns[0][0] != "human":
        turns = turns[1:]

    if template.sep_style == "plain":
        turns = [("human", IMAGE_PLACEHOLDER if has_image else turns[0][1]),
                 ("gpt", turns[1][1])]

    ids: List[int] = []
    labels: List[int] = []
    if tokenizer.bos_token_id is not None:
        ids.append(tokenizer.bos_token_id)
        labels.append(IGNORE_INDEX)
    for text, is_target in template.render(turns):
        seg_ids: List[int] = []
        for i, chunk in enumerate(text.split(IMAGE_PLACEHOLDER)):
            if i > 0:
                seg_ids.append(IMAGE_TOKEN_INDEX)
            seg_ids.extend(_encode(tokenizer, chunk))
        ids.extend(seg_ids)
        labels.extend(seg_ids if is_target else [IGNORE_INDEX] * len(seg_ids))

    if max_length:
        ids, labels = ids[:max_length], labels[:max_length]
    return np.asarray(ids, np.int32), np.asarray(labels, np.int32)
