"""Tokenization for the serving layer (port of
``distributed_inference_server_tpu/models/tokenizer.py``: ``ByteTokenizer``,
``HFTokenizer``, ``load_tokenizer`` and the chat templates).

Two backends behind one interface:

- ``HFTokenizer`` wraps a checkpoint's ``tokenizer.json`` through the
  ``tokenizers`` library, imported when one is built (as the reference
  does), so this module imports where the library is absent;
- ``ByteTokenizer`` (ids 0-255 are raw bytes, 256 = BOS, 257 = EOS) serves
  random-weight models and checkpoint directories without
  ``tokenizer.json``.

Chat templates: ``load_chat_template`` compiles a checkpoint's own Jinja
``chat_template`` (``tokenizer_config.json``), which ``load_tokenizer``
attaches to the tokenizer as ``chat_template``; ``render_chat`` prefers it
and falls back to the per-family table (``apply_chat_template``: llama3,
mistral, chatml, gemma) keyed on the model name.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, List, Optional, Protocol, Sequence

from distributed_inference_server_tpu_torch.core.errors import ModelLoadError
from distributed_inference_server_tpu_torch.core.models import ChatMessage

logger = logging.getLogger(__name__)


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
    tokenizer. The checkpoint's own chat template, when its
    ``tokenizer_config.json`` carries one, is attached as the tokenizer's
    ``chat_template`` (``render_chat`` prefers it to the family table)."""
    if not model_dir:
        return ByteTokenizer()
    path = os.path.join(model_dir, "tokenizer.json")
    tok: Tokenizer = (HFTokenizer(path) if os.path.exists(path)
                      else ByteTokenizer())
    template = load_chat_template(model_dir)
    if template is not None:
        tok.chat_template = template  # type: ignore[attr-defined]
    return tok


def _special_token_text(value) -> str:
    """``tokenizer_config.json`` writes a special token as a plain string
    or as an AddedToken dict ``{"content": "...", ...}``."""
    if isinstance(value, dict):
        return str(value.get("content", ""))
    return str(value) if value is not None else ""


def load_chat_template(
    model_dir: str,
) -> Optional[Callable[[Sequence[ChatMessage]], str]]:
    """The checkpoint's Jinja chat template compiled into a renderer, or
    None when the directory ships no usable one.

    ``chat_template`` in ``tokenizer_config.json`` is a Jinja string or a
    list of ``{"name", "template"}`` entries, of which the ``"default"``
    one is the chat template (a list without one counts as absent). It
    renders as Hugging Face renders it: a sandboxed immutable Jinja
    environment with ``raise_exception``, ``messages`` as ``{"role",
    "content"}`` dicts, ``add_generation_prompt=True`` and the config's
    ``bos_token`` / ``eos_token``. A template that does not compile counts
    as absent."""
    try:
        with open(os.path.join(model_dir, "tokenizer_config.json")) as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return None
    source = cfg.get("chat_template")
    if isinstance(source, list):
        by_name = {e.get("name"): e.get("template")
                   for e in source if isinstance(e, dict)}
        source = by_name.get("default")
    if not isinstance(source, str) or not source.strip():
        return None
    try:
        from jinja2.exceptions import TemplateError
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError:
        return None

    def _raise_exception(message: str):
        raise TemplateError(message)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
    env.globals["raise_exception"] = _raise_exception
    try:
        compiled = env.from_string(source)
    except TemplateError:
        return None
    bos = _special_token_text(cfg.get("bos_token"))
    eos = _special_token_text(cfg.get("eos_token"))

    def render(messages: Sequence[ChatMessage]) -> str:
        return compiled.render(
            messages=[{"role": m.role.value, "content": m.content}
                      for m in messages],
            add_generation_prompt=True, bos_token=bos, eos_token=eos)

    return render


def render_chat(messages: Sequence[ChatMessage],
                tokenizer: Optional[Tokenizer] = None,
                model_name: str = "") -> str:
    """A conversation rendered for generation: by the checkpoint's own
    template when the tokenizer carries one, else by the family table for
    ``model_name``. A template that raises while rendering (one that
    refuses system messages, say) falls back to the family table, with
    one warning per tokenizer."""
    template = getattr(tokenizer, "chat_template", None)
    if template is not None:
        try:
            return template(messages)
        except Exception as e:  # noqa: BLE001 — any template failure
            if not getattr(tokenizer, "_chat_template_warned", False):
                logger.warning(
                    "checkpoint chat_template failed to render (%s); "
                    "falling back to the %r family template", e,
                    chat_template_family(model_name))
                try:
                    tokenizer._chat_template_warned = True  # type: ignore[union-attr]
                except AttributeError:
                    pass
    return apply_chat_template(messages, chat_template_family(model_name))


def chat_template_family(model_name: str) -> str:
    """Template family for a model name; unknown names are llama3."""
    n = (model_name or "").lower()
    if "mistral" in n or "mixtral" in n:
        return "mistral"
    if "qwen" in n:
        return "chatml"
    if "gemma" in n:
        return "gemma"
    return "llama3"


def _fold_system(messages: Sequence[ChatMessage], open_turn, close_turn,
                 assistant_turn) -> List[str]:
    """Turns of a family with no system slot (mistral, gemma): system
    contents accumulate and fold into the next user turn, joined by blank
    lines; what is left after the last user turn becomes a user turn of
    its own."""
    parts: List[str] = []
    pending: List[str] = []
    for m in messages:
        role = m.role.value
        if role == "system":
            pending.append(m.content)
        elif role == "user":
            parts.append(open_turn("\n\n".join(pending + [m.content])))
            pending = []
        else:
            parts.append(assistant_turn(m.content))
    if pending:
        parts.append(open_turn("\n\n".join(pending)))
    return parts + [close_turn]


def apply_chat_template(messages: Sequence[ChatMessage],
                        family: str = "llama3") -> str:
    """A conversation in the family's instruct format:

    - ``llama3``: ``<|start_header_id|>role<|end_header_id|>`` headers,
      ``<|eot_id|>`` turn ends, the assistant header appended;
    - ``mistral``: ``[INST] user [/INST] assistant</s>`` pairs;
    - ``chatml`` (Qwen2): ``<|im_start|>role\\n...<|im_end|>`` blocks and
      ``<|im_start|>assistant`` to generate;
    - ``gemma`` (Gemma-2): ``<start_of_turn>user/model`` turns (the
      assistant is ``model``).

    Mistral and Gemma have no system slot: ``_fold_system``."""
    if family == "mistral":
        return "<s>" + "".join(_fold_system(
            messages, lambda c: f"[INST] {c} [/INST]", "",
            lambda c: f" {c}</s>"))
    if family == "chatml":
        return "".join(
            [f"<|im_start|>{m.role.value}\n{m.content}<|im_end|>\n"
             for m in messages] + ["<|im_start|>assistant\n"])
    if family == "gemma":
        return "<bos>" + "".join(_fold_system(
            messages, lambda c: f"<start_of_turn>user\n{c}<end_of_turn>\n",
            "<start_of_turn>model\n",
            lambda c: f"<start_of_turn>model\n{c}<end_of_turn>\n"))
    return "".join(
        ["<|begin_of_text|>"]
        + [f"<|start_header_id|>{m.role.value}<|end_header_id|>\n\n"
           f"{m.content}<|eot_id|>" for m in messages]
        + ["<|start_header_id|>assistant<|end_header_id|>\n\n"])
