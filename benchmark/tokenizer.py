"""The benchmark's tokenizer: every id of the model's vocabulary is a
distinct three-character piece of letters and digits.

A served model's stream carries text, not ids. The port's byte tokenizer
decodes every id above 257 to nothing, so a random-weight model's stream
would say nothing about which token was served, and frames would carry
empty text where a deployed tokenizer sends a piece per token. Here
``decode_token`` gives each id its own piece and ``encode`` reads pieces
back, so the client recovers the served ids exactly, and a prompt of n
tokens is a text of 3(n - 1) characters (the BOS is added by ``encode``).
BOS and EOS are Mistral's ids (1 and 2). No piece ends in U+FFFD, so the
engine never holds text back.
"""

from __future__ import annotations

import string
from typing import List, Sequence

ALPHABET = string.ascii_letters + string.digits  # 62 symbols
WIDTH = 3  # 62 ** 3 = 238328 pieces


def piece(token_id: int) -> str:
    n = len(ALPHABET)
    return "".join(ALPHABET[(token_id // n ** k) % n]
                   for k in reversed(range(WIDTH)))


def piece_id(text: str) -> int:
    n, out = len(ALPHABET), 0
    for ch in text:
        out = out * n + ALPHABET.index(ch)
    return out


def ids_of(text: str) -> List[int]:
    """The ids of a text of whole pieces."""
    if len(text) % WIDTH:
        raise ValueError(f"text length {len(text)} is not a multiple of "
                         f"{WIDTH}")
    return [piece_id(text[i:i + WIDTH]) for i in range(0, len(text), WIDTH)]


def text_of(ids: Sequence[int]) -> str:
    return "".join(piece(int(i)) for i in ids)


class PieceTokenizer:
    """The port's ``Tokenizer`` protocol over ``vocab_size`` pieces."""

    def __init__(self, vocab_size: int, bos_id: int = 1, eos_id: int = 2):
        if vocab_size > len(ALPHABET) ** WIDTH:
            raise ValueError(f"vocabulary {vocab_size} exceeds "
                             f"{len(ALPHABET) ** WIDTH} pieces")
        self.vocab_size = vocab_size
        self.bos_id = bos_id
        self.eos_ids = (eos_id,)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = ids_of(text)
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return text_of(i for i in ids if i not in self.eos_ids)

    def decode_token(self, token_id: int) -> str:
        return piece(token_id)
