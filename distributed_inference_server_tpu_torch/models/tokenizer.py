"""Tokenization for the serving layer (port of
``distributed_inference_server_tpu/models/tokenizer.py``: the byte-level
tokenizer and ``load_tokenizer`` for the no-checkpoint case).

Checkpoint tokenizers (``tokenizer.json``) wait until real weights and a
tokenizer ship with the repository; until then every model serves through
``ByteTokenizer`` (ids 0-255 are raw bytes, 256 = BOS, 257 = EOS).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    bos_id: int
    eos_ids: Sequence[int]
    vocab_size: int

    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def decode_token(self, token_id: int) -> str: ...


class ByteTokenizer:
    """Byte-level tokenizer: id i < 256 is byte i; 256=BOS, 257=EOS."""

    def __init__(self) -> None:
        self.bos_id = 256
        self.eos_ids = (257,)
        self.vocab_size = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    def decode_token(self, token_id: int) -> str:
        return self.decode([token_id])


def load_tokenizer(model_dir: Optional[str] = None) -> Tokenizer:
    """The byte tokenizer; a checkpoint directory is not supported yet."""
    if model_dir:
        raise NotImplementedError(
            "checkpoint tokenizers are not ported yet; serve without "
            "model_dir (ByteTokenizer)"
        )
    return ByteTokenizer()
