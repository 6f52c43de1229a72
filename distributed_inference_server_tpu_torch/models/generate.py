"""Single-sequence / static-batch generation over the dense KV cache (port
of ``distributed_inference_server_tpu/models/generate.py``).

The simplest loop over the model: prefill the right-padded prompts, then
decode one token per step for every row until each has stopped (EOS or
its budget). It is the correctness anchor of the paged engine and of the
checkpoint parity tests, not a serving path: the loop runs on the host
and reads one flag per step to stop early, where the JAX package runs it
on the device in one ``lax.while_loop``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.models.llama import (
    KVCache,
    Params,
    forward,
)
from distributed_inference_server_tpu_torch.ops.sampling import sample_tokens


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new] generated ids (padded with 0)
    lengths: torch.Tensor  # [B] number of valid generated tokens
    finished_eos: torch.Tensor  # [B] bool: stopped on EOS (vs length)


@torch.no_grad()
def generate(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, T] right-padded prompts
    prompt_lens: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] (0 = greedy)
    top_p: torch.Tensor,  # [B] (1 = off)
    max_new_tokens: int,
    max_seq: int,
    eos_ids: Tuple[int, ...] = (),
) -> GenerateResult:
    """Prefill + decode loop on the params' device; random draws come from
    ``generator`` (on that device). Returns the generated tokens per row;
    EOS tokens finish a row and are not emitted."""
    dev = params["embed"].device
    input_ids = input_ids.to(dev)
    prompt_lens = prompt_lens.to(dev, torch.int32)
    temperature = temperature.to(dev, torch.float32)
    top_p = top_p.to(dev, torch.float32)
    B, T = input_ids.shape
    cache = KVCache.create(cfg, B, max_seq, dtype=params["embed"].dtype,
                           device=dev)

    # ---- prefill ----
    positions = torch.arange(T, device=dev).expand(B, T)
    in_prompt = positions < prompt_lens[:, None]
    write_pos = torch.where(in_prompt, positions,
                            torch.full_like(positions, max_seq))
    logits, cache = forward(params, cfg, input_ids, positions, cache,
                            write_pos, prompt_lens)
    # logits at the last *valid* prompt token per row
    rows = torch.arange(B, device=dev)
    next_logits = logits[rows, (prompt_lens - 1).clamp(min=0).long()]

    eos = torch.tensor(list(eos_ids) or [-1], dtype=torch.int32, device=dev)
    seq_lens = prompt_lens.clone()
    out_tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32,
                             device=dev)
    out_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = prompt_lens <= 0
    done_eos = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(max_new_tokens):
        if bool(done.all()):
            break
        tokens = sample_tokens(next_logits, temperature, top_p, generator)
        is_eos = (tokens[:, None] == eos[None, :]).any(-1)
        emit = ~done
        # rows past their budget write nothing (the JAX "drop")
        col = out_len.long().clamp(max=max_new_tokens - 1)
        keep = emit & (out_len < max_new_tokens)
        out_tokens[rows, col] = torch.where(keep, tokens,
                                            out_tokens[rows, col])
        # EOS tokens finish a row; they are not emitted to the client
        emit_token = emit & ~is_eos
        out_len = out_len + emit_token.int()
        done_eos = done_eos | (emit & is_eos)
        done = done | (emit & is_eos)

        # one decode step for every row (finished rows write nothing)
        pos = seq_lens
        write = torch.where(emit_token, pos, torch.full_like(pos, max_seq))
        logits, cache = forward(params, cfg, tokens[:, None], pos[:, None],
                                cache, write[:, None],
                                seq_lens + emit_token.int())
        seq_lens = seq_lens + emit_token.int()
        done = done | (seq_lens >= max_seq) | (out_len >= max_new_tokens)
        next_logits = logits[:, 0]
    return GenerateResult(tokens=out_tokens, lengths=out_len,
                          finished_eos=done_eos)


def greedy_generate(
    params: Params,
    cfg: ModelConfig,
    prompt_ids: Sequence[int],
    max_new_tokens: int = 32,
    max_seq: int = 256,
    eos_ids: Tuple[int, ...] = (),
) -> List[int]:
    """Greedy-decode one prompt (a list of ids); returns the new ids."""
    result = generate(
        params, cfg, torch.tensor([list(prompt_ids)], dtype=torch.int32),
        torch.tensor([len(prompt_ids)], dtype=torch.int32), None,
        torch.zeros((1,)), torch.ones((1,)), max_new_tokens, max_seq,
        eos_ids)
    n = int(result.lengths[0])
    return result.tokens[0, :n].tolist()
