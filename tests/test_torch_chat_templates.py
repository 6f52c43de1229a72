"""The port's chat templates against the JAX package's.

The cases of ``tests/test_chat_templates.py`` run on the port's
``models/tokenizer.py``, and every rendering is held against the JAX
renderer's on the same messages: the four families (llama3, mistral,
chatml, gemma) over every conversation of up to four messages, and the
checkpoint templates (a file's Jinja template, its list form, special
tokens, a template that refuses system messages, the HF fixture's).
"""

import itertools
import json
import os

import pytest

from distributed_inference_server_tpu.core.models import (
    ChatMessage as JChatMessage,
)
from distributed_inference_server_tpu.core.models import Role as JRole
from distributed_inference_server_tpu.models import tokenizer as jtok
from distributed_inference_server_tpu_torch.core.models import (
    ChatMessage,
    Role,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
    apply_chat_template,
    chat_template_family,
    load_chat_template,
    load_tokenizer,
    render_chat,
)

FAMILIES = ("llama3", "mistral", "chatml", "gemma")
CKPT = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_llama_hf")

CONVO = [
    ChatMessage(role=Role.SYSTEM, content="be brief"),
    ChatMessage(role=Role.USER, content="hi"),
    ChatMessage(role=Role.ASSISTANT, content="hello"),
    ChatMessage(role=Role.USER, content="bye"),
]


def _jax(messages):
    return [JChatMessage(role=JRole(m.role.value), content=m.content)
            for m in messages]


# -- the reference's cases ----------------------------------------------------


def test_model_names_map_to_families():
    for name, fam in [("llama-3-8b", "llama3"), ("llama-3.2-1b", "llama3"),
                      ("mistral-7b", "mistral"), ("mixtral-8x7b", "mistral"),
                      ("qwen2-7b", "chatml"), ("gemma2-9b", "gemma"),
                      ("tiny", "llama3"), ("", "llama3")]:
        assert chat_template_family(name) == fam
        assert jtok.chat_template_family(name) == fam


def test_llama3_headers():
    out = apply_chat_template(CONVO, "llama3")
    assert out.startswith("<|begin_of_text|>")
    assert ("<|start_header_id|>system<|end_header_id|>\n\nbe brief"
            "<|eot_id|>") in out
    assert out.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")


def test_mistral_inst_pairs_fold_system():
    assert apply_chat_template(CONVO, "mistral") == (
        "<s>[INST] be brief\n\nhi [/INST] hello</s>[INST] bye [/INST]")


def test_chatml_blocks():
    assert apply_chat_template(CONVO, "chatml") == (
        "<|im_start|>system\nbe brief<|im_end|>\n"
        "<|im_start|>user\nhi<|im_end|>\n"
        "<|im_start|>assistant\nhello<|im_end|>\n"
        "<|im_start|>user\nbye<|im_end|>\n"
        "<|im_start|>assistant\n")


def test_gemma_turns_rename_assistant_to_model():
    assert apply_chat_template(CONVO, "gemma") == (
        "<bos><start_of_turn>user\nbe brief\n\nhi<end_of_turn>\n"
        "<start_of_turn>model\nhello<end_of_turn>\n"
        "<start_of_turn>user\nbye<end_of_turn>\n"
        "<start_of_turn>model\n")


def test_default_family_is_llama3():
    assert apply_chat_template(CONVO) == apply_chat_template(CONVO, "llama3")


@pytest.mark.parametrize("family,messages,want", [
    ("mistral", [("user", "hi"), ("system", "be brief")],
     "<s>[INST] hi [/INST][INST] be brief [/INST]"),
    ("mistral", [("system", "one"), ("system", "two"), ("user", "hi")],
     "<s>[INST] one\n\ntwo\n\nhi [/INST]"),
    ("gemma", [("user", "hi"), ("system", "be brief")],
     "<bos><start_of_turn>user\nhi<end_of_turn>\n"
     "<start_of_turn>user\nbe brief<end_of_turn>\n<start_of_turn>model\n"),
])
def test_system_content_never_dropped(family, messages, want):
    msgs = [ChatMessage(role=Role(r), content=c) for r, c in messages]
    assert apply_chat_template(msgs, family) == want


def test_handler_family_follows_model_name():
    from distributed_inference_server_tpu_torch.serving.handler import (
        InferenceHandler,
    )

    from distributed_inference_server_tpu_torch.serving.metrics import (
        MetricsCollector,
    )

    h = InferenceHandler(None, ByteTokenizer(), "qwen2-7b",
                         MetricsCollector())
    assert h.chat_family == "chatml"
    h.model_name = "gemma2-9b"
    assert h.chat_family == "gemma"


# -- every family against the JAX renderer ------------------------------------


def _conversations():
    roles = [Role.SYSTEM, Role.USER, Role.ASSISTANT]
    for n in range(5):
        for combo in itertools.product(roles, repeat=n):
            yield [ChatMessage(role=r, content=f"m{i} {r.value} é🙂")
                   for i, r in enumerate(combo)]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_renders_equal_jax(family):
    n = 0
    for msgs in _conversations():
        assert apply_chat_template(msgs, family) == \
            jtok.apply_chat_template(_jax(msgs), family), msgs
        n += 1
    assert n == 121


# -- checkpoint templates -------------------------------------------------------

CHATML_JINJA = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\\n' + message['content'] "
    "+ '<|im_end|>' + '\\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}"
    "{% endif %}"
)
CHATML_RENDERED = (
    "<|im_start|>system\nbe brief<|im_end|>\n"
    "<|im_start|>user\nhi<|im_end|>\n"
    "<|im_start|>assistant\nhello<|im_end|>\n"
    "<|im_start|>user\nbye<|im_end|>\n"
    "<|im_start|>assistant\n"
)
REFUSES_SYSTEM = (
    "{% for m in messages %}"
    "{% if m['role'] == 'system' %}"
    "{{ raise_exception('no system role') }}{% endif %}"
    "{{ m['content'] }}{% endfor %}"
)


def _write_cfg(path, cfg: dict) -> str:
    path.mkdir(exist_ok=True)
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(path)


def _both(d, msgs, name):
    """(port rendering, JAX rendering) through each package's
    load_tokenizer + render_chat."""
    return (render_chat(msgs, load_tokenizer(d), name),
            jtok.render_chat(_jax(msgs), jtok.load_tokenizer(d), name))


def test_template_from_file_beats_name_sniffing(tmp_path):
    d = _write_cfg(tmp_path / "my-assistant-v2",
                   {"chat_template": CHATML_JINJA})
    assert chat_template_family("my-assistant-v2") == "llama3"
    got, want = _both(d, CONVO, "my-assistant-v2")
    assert got == want == CHATML_RENDERED


def test_no_config_falls_back_to_family(tmp_path):
    tok = load_tokenizer(str(tmp_path))
    assert getattr(tok, "chat_template", None) is None
    assert render_chat(CONVO, tok, "qwen2-7b") == apply_chat_template(
        CONVO, "chatml")


def test_list_form_picks_default_entry(tmp_path):
    d = _write_cfg(tmp_path, {"chat_template": [
        {"name": "tool_use", "template": "TOOLS"},
        {"name": "default", "template": CHATML_JINJA}]})
    assert load_chat_template(d)(CONVO) == CHATML_RENDERED


def test_special_tokens_rendered_from_config(tmp_path):
    d = _write_cfg(tmp_path, {
        "chat_template": ("{{ bos_token }}{% for m in messages %}"
                          "{{ m['content'] }}{{ eos_token }}{% endfor %}"),
        "bos_token": {"content": "<s>"}, "eos_token": "</s>"})
    msgs = [ChatMessage(role=Role.USER, content="hi")]
    assert load_chat_template(d)(msgs) == "<s>hi</s>"
    got, want = _both(d, msgs, "tiny")
    assert got == want


@pytest.mark.parametrize("cfg", [
    {"chat_template": [{"name": "rag", "template": "RAG"},
                       {"name": "tool_use", "template": "TOOLS"}]},
    {"chat_template": "{% for m in %}broken"},
    {"chat_template": "   "},
    {},
])
def test_unusable_template_is_absent(tmp_path, cfg):
    d = _write_cfg(tmp_path, cfg)
    assert load_chat_template(d) is None
    assert jtok.load_chat_template(d) is None


def test_render_time_error_falls_back_to_family(tmp_path, caplog):
    d = _write_cfg(tmp_path, {"chat_template": REFUSES_SYSTEM})
    tok = load_tokenizer(d)
    for _ in range(2):  # one warning per tokenizer
        assert render_chat(CONVO, tok, "qwen2-7b") == apply_chat_template(
            CONVO, "chatml")
    assert sum("failed to render" in r.message
               for r in caplog.records) == 1
    ok = [ChatMessage(role=Role.USER, content="hi")]
    assert render_chat(ok, tok, "qwen2-7b") == "hi"
    got, want = _both(d, CONVO, "qwen2-7b")
    assert got == want


@pytest.mark.parametrize("family", ["tiny", "mistral-7b", "gemma2-9b"])
def test_fixture_checkpoint_template_equals_jax(family):
    """The HF fixture's ``tokenizer_config.json`` template, attached by
    ``load_tokenizer`` (with its ``tokenizer.json``), renders as the JAX
    package renders it, whatever the model name."""
    pytest.importorskip("tokenizers")
    tok = load_tokenizer(CKPT)
    assert callable(getattr(tok, "chat_template", None))
    for msgs in itertools.islice(_conversations(), 1, None, 7):
        got, want = _both(CKPT, msgs, family)
        assert got == want
        assert got == tok.chat_template(msgs)
