"""The window's arithmetic and the bounds, against hand counts."""
import math

import pytest

from hbench import roofline, stats


def test_itl_tail_over_all_gaps():
    # 19 steps of 10 ms that each give 100 slots a token, one of 50 ms
    # that gives 10: 10 of 1910 gaps (0.5%) are long, so p95 is 10 ms;
    # a percentile of the steps would not weigh them so
    dt = [0.010] * 19 + [0.050]
    n = [100] * 19 + [10]
    assert stats.itl_p95_ms(dt, n) == pytest.approx(10.0)
    # with one long step in ten carrying every slot, p95 is the long one
    assert stats.itl_p95_ms([0.010] * 9 + [0.050], [100] * 10) == pytest.approx(50.0)


def test_rate_over_whole_steps():
    assert stats.rate([70000, 70000, 70000], [5.0, 5.0, 4.0]) == pytest.approx(15000.0)


def test_busy_is_the_union_of_intervals():
    busy, gaps = stats.busy_and_gaps([(1, 3), (2, 4), (6, 7), (6.5, 6.8), (9, 12)], 0, 10)
    assert busy == pytest.approx(3 + 1 + 1)
    assert gaps == [(0, 1), (4, 6), (7, 9)]


QWEN = {"n_layers": 28, "d_model": 1536, "n_heads": 12, "n_kv_heads": 2, "head_dim": 128,
        "d_ff": 8960, "vocab_size": 151936, "n_experts": 0, "experts_per_token": 0}


def test_flash_bounds_by_hand():
    # one packed row: segments of 4096 and 2048 tokens
    pairs = 4096 * 4097 // 2 + 2048 * 2049 // 2
    assert roofline.causal_pairs([4096, 2048]) == pairs
    flops = 4 * 12 * 128 * pairs
    nbytes = 6144 * 128 * (24 + 4) * 2 + 4 * 6144 * 12
    assert roofline.flash_forward(QWEN, [4096, 2048]) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert roofline.flash_backward(QWEN, [4096, 2048]) == pytest.approx(
        max(10 * 12 * 128 * pairs / 989e12,
            (6144 * 128 * (48 + 8) * 2 + 4 * 6144 * 12) / 3.35e12))


def test_paged_decode_bound_by_hand():
    # 3 slots reading 100, 200, 300 keys through 25 distinct blocks of 16
    nbytes = 25 * 16 * 2 * 128 * 2 * 2 + 2 * 3 * 12 * 128 * 2 + 4 * 3
    flops = 4 * 12 * 128 * 600
    assert roofline.paged_decode(QWEN, [100, 200, 300], 25, 16) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))


def test_model_flops_by_hand():
    per_layer = 2 * 1536 * 1536 + 2 * 1536 * 256 + 3 * 1536 * 8960
    assert roofline.matmul_params(QWEN) == 28 * per_layer + 1536 * 151936
    moe = dict(QWEN, n_layers=8, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
               vocab_size=50304, n_experts=64, experts_per_token=8)
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert roofline.matmul_params(moe) == 8 * per_layer + 2048 * 50304
    assert roofline.attention_flops_per_key(QWEN) == 4 * 28 * 12 * 128
    assert math.isclose(roofline.PEAK_FLOPS, 989e12)
