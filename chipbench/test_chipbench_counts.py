"""The frozen counts at the cells' shapes, against values worked out by
hand."""
import json

import pytest

from chipbench import harness
from chipbench.counts import model, peaks, secagg

QWEN3 = harness.load_json(harness.HERE / "configs" / "qwen3-1.7b.json")


def test_secure_agg_kernels_at_64_by_2_22():
    n, T = 64, 1 << 22
    N = n * T                                     # 268,435,456 elements
    assert secagg.mask_work(n, T) == (2_147_484_416, 12 * N + 64 * 21, 4 * N)
    nbytes, int_ops, float_ops = secagg.unmask_work(n, T, n)
    assert (nbytes, int_ops) == (8 * N + 8 * 64, 206_158_516_224)
    # r = 3: three compare-exchanges, two ops each, and the add
    assert secagg.network_exchanges(3) == 3
    assert secagg.vote_work(3, N) == (20 * N, 7 * N, 0)
    assert secagg.voted_rounds("ring", 16) == 15
    # the unmask is bound by its integer operations: 12.32 ms
    assert peaks.bound_s(nbytes, int_ops=int_ops, float_ops=float_ops) \
        == pytest.approx(12.32e-3, rel=1e-3)
    assert peaks.bound_s(20 * N, int_ops=7 * N) == \
        pytest.approx(20 * N / 3.35e12)


def test_flash_at_4_by_2048_16_8_heads_hd128():
    B, S = 4, 2048
    pairs = 2048 * 2049 // 2                      # 2,098,176
    assert model.causal_pairs(S) == pairs
    fwd_bytes, fwd_flops = model.flash_fwd_work(QWEN3, B, S)
    q = B * S * 16 * 128                          # 16,777,216
    kv = B * S * 8 * 128                          # 8,388,608
    assert fwd_flops == 4 * B * 16 * 128 * pairs == 68_753_031_168
    assert fwd_bytes == 2 * (2 * q + 2 * kv) + 4 * B * 16 * S == 101_187_584
    bwd_bytes, bwd_flops = model.flash_bwd_work(QWEN3, B, S)
    assert bwd_flops == 171_882_577_920           # five products
    assert bwd_bytes == 2 * (4 * q + 4 * kv) + 4 * B * 16 * S


def test_qwen3_1p7b_step():
    per_layer = 2048 * 2048 * 2 + 2 * 2048 * 1024 + 3 * 2048 * 6144
    params = 28 * per_layer + 2048 * 151936
    assert model.matmul_params(QWEN3) == params == 1_720_451_072
    flops = model.train_step_flops(QWEN3, 4, 2048)
    assert flops == 6 * params * 8192 + 3 * 28 * 68_753_031_168
    assert flops == pytest.approx(9.03e13, rel=2e-3)


def test_counts_are_data_driven_by_the_config_file():
    small = json.loads(json.dumps(QWEN3))
    small["num_hidden_layers"] = 1
    per_layer = 2048 * 2048 * 2 + 2 * 2048 * 1024 + 3 * 2048 * 6144
    assert model.train_step_flops(small, 4, 2048) == \
        6 * (per_layer + 2048 * 151936) * 8192 + 3 * 68_753_031_168
