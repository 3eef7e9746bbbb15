"""Tokenization for the serving path (counterpart of the JAX package's
`data/preprocess.py`, the parts generation needs).

- `SimpleTokenizer`: the dependency-free whitespace tokenizer with
  hash-bucketed ids used in tests and smoke runs. Its ids come from Python's
  `hash`, so they agree between the two packages within one process.
- `tokenizer_image_token`: split on '<image>', tokenize chunks, splice the
  IMAGE_TOKEN_INDEX (-200) sentinel (`llava/mm_utils.py:41-58`).
"""

from __future__ import annotations

from typing import List

from ..models.splice import IMAGE_TOKEN_INDEX
from .conversation import IMAGE_PLACEHOLDER


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
