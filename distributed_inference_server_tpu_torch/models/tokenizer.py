"""Tokenization for the serving layer (port of
``distributed_inference_server_tpu/models/tokenizer.py``: ``ByteTokenizer``,
``HFTokenizer`` and ``load_tokenizer``).

Two backends behind one interface:

- ``HFTokenizer`` wraps a checkpoint's ``tokenizer.json`` through the
  ``tokenizers`` library, imported when one is built (as the reference
  does), so this module imports where the library is absent;
- ``ByteTokenizer`` (ids 0-255 are raw bytes, 256 = BOS, 257 = EOS) serves
  random-weight models and checkpoint directories without
  ``tokenizer.json``.

Chat templates (``load_chat_template``, ``render_chat``) come with
``/chat``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Protocol, Sequence

from distributed_inference_server_tpu_torch.core.errors import ModelLoadError


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


class HFTokenizer:
    """Wraps a HuggingFace ``tokenizer.json`` (tokenizers library)."""

    def __init__(self, path: str, bos_id: Optional[int] = None,
                 eos_ids: Optional[Sequence[int]] = None):
        try:
            from tokenizers import Tokenizer as _Tok
        except ImportError:
            raise ModelLoadError(
                f"{path} needs the tokenizers package, which is not "
                "installed") from None

        self._tok = _Tok.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = (
            bos_id if bos_id is not None
            else (self._tok.token_to_id("<|begin_of_text|>") or 0))
        if eos_ids is None:
            candidates = [self._tok.token_to_id(t)
                          for t in ("<|end_of_text|>", "<|eot_id|>", "</s>")]
            eos_ids = tuple(c for c in candidates if c is not None) or (0,)
        self.eos_ids = tuple(eos_ids)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def decode_token(self, token_id: int) -> str:
        return self._tok.decode([token_id], skip_special_tokens=True)


def load_tokenizer(model_dir: Optional[str] = None) -> Tokenizer:
    """The checkpoint's ``tokenizer.json`` when ``model_dir`` has one (a
    ``ModelLoadError`` if ``tokenizers`` is missing then), else the byte
    tokenizer."""
    if model_dir:
        path = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(path):
            return HFTokenizer(path)
    return ByteTokenizer()
