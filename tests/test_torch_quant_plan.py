"""The group-dequant matmul's launch plan (``quant_matmul.plan``), on the CPU.

The plan is plain Python: which column block the decode body (M <= 16)
takes and how K is split over blocks. For every product of a served layer
(llama-3-8b and llama-3.2-1b, each with int8's group 128 and int4's group
64) at decode batch sizes on an H100's 132 SMs, the splits must cover K
exactly in whole 64-row tiles, each tile inside one group or holding whole
groups, no split empty, and the grid must hold at least two blocks per SM;
a grid that fits in one wave of resident blocks is not split further.
"""

from __future__ import annotations

import pytest
import torch

from distributed_inference_server_tpu_torch.models.configs import (
    LLAMA_3_2_1B,
    LLAMA_3_8B,
)
from distributed_inference_server_tpu_torch.ops.kernels.quant_matmul import (
    plan,
)

H100_SMS = 132
TILE_K = 64
# decode blocks one SM holds per column block (the kernel's occupancy
# query reports the card's own; these are of its order)
RESIDENT = {128: 3, 64: 5, 32: 8}


def _products(cfg):
    """(name, K, N) of the seven products of one layer."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return [("wq", H, q), ("wk", H, kv), ("wv", H, kv), ("wo", q, H),
            ("w_gate", H, I), ("w_up", H, I), ("w_down", I, H)]


CASES = [(model, name, K, N, group)
         for model, cfg in (("llama-3-8b", LLAMA_3_8B),
                            ("llama-3.2-1b", LLAMA_3_2_1B))
         for name, K, N in _products(cfg)
         for group in (128, 64)]


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("model,name,K,N,group", CASES)
def test_decode_plan_covers_k_and_fills_the_card(model, name, K, N, group, M):
    bm, bn, splits, rows = plan(M, K, N, torch.bfloat16, H100_SMS,
                                RESIDENT)
    assert bm == 16 and bn in (128, 64, 32)
    # whole tiles, each inside one group or holding whole groups
    assert rows % TILE_K == 0
    assert TILE_K % group == 0 or group % TILE_K == 0
    # the splits cover K exactly and none is empty
    assert (splits - 1) * rows < K <= splits * rows
    assert splits <= 32
    # at least two blocks per SM
    blocks = -(-N // bn) * splits
    assert blocks >= 2 * H100_SMS
    # no more waves of resident blocks than the fewest splits that fill
    # the card would take
    waves = -(-blocks // (RESIDENT[bn] * H100_SMS))
    assert waves * (rows // TILE_K) <= -(-K // TILE_K)


@pytest.mark.parametrize("M,K,N,dtype,tile", [
    (2048, 4096, 14336, torch.bfloat16, (256, 128)),
    (2048, 4096, 4096, torch.bfloat16, (256, 128)),
    (2048, 4096, 1024, torch.bfloat16, (128, 128)),
    (512, 4096, 14336, torch.bfloat16, (256, 128)),
    (512, 4096, 4096, torch.bfloat16, (128, 128)),
    (1024, 4096, 4096, torch.bfloat16, (128, 128)),
    (17, 4096, 1024, torch.bfloat16, (128, 128)),
    (8, 4096, 1024, torch.float32, (0, 0)), (1, 64, 32, torch.float32, (0, 0))])
def test_prefill_and_f32_run_unsplit(M, K, N, dtype, tile):
    """Prefill takes the largest tile whose grid still gives every SM a
    block; float32 runs its own body."""
    assert plan(M, K, N, dtype, H100_SMS) == (*tile, 1, K)


@pytest.mark.parametrize("K,N", [(64, 16), (192, 136), (128, 8200)])
def test_small_products_take_the_narrowest_block(K, N):
    """A product too small to fill the card still gets a valid plan."""
    _, bn, splits, rows = plan(8, K, N, torch.bfloat16, H100_SMS, RESIDENT)
    assert (splits - 1) * rows < K <= splits * rows and rows % TILE_K == 0
    if -(-N // 128) * -(-K // TILE_K) < 2 * H100_SMS and N <= 136:
        assert bn == 32
