"""The benchmark's operation and byte counts, checked by hand."""

import os

import pytest

from benchmark.harness import flops as F
from benchmark.harness.weights import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(name):
    return load_config(os.path.join(ROOT, "benchmark", "configs",
                                    name + ".json"))


def test_attention_call_at_the_train_shape():
    # (B, H, S, D) = (8, 16, 320, 64): B * H = 128
    assert F.attention_fwd_flops(8, 16, 320, 64) == 4 * 128 * 320 * 320 * 64
    assert F.attention_fwd_flops(8, 16, 320, 64) == pytest.approx(3.355e9,
                                                                  rel=1e-3)
    # q, k, v, o in bf16, the f32 log-sum-exp, the int32 key mask
    assert F.attention_fwd_bytes(8, 16, 320, 64) == (
        4 * 128 * 320 * 64 * 2 + 128 * 320 * 4 + 8 * 320 * 4) == 21145600
    assert F.attention_bwd_flops(8, 16, 320, 64) == pytest.approx(8.389e9,
                                                                  rel=1e-3)
    assert F.attention_bwd_bytes(8, 16, 320, 64) == 42117120
    # bytes bound it: 21.1 MB at 3.35 TB/s is above 3.36 GFLOP at 989 TFLOP/s
    assert F.least_seconds(3.355e9, 21145600) == pytest.approx(
        21145600 / 3.35e12)


def test_one_roberta_large_layer():
    enc = _cfg("roberta-large-heatmap")["encoder"]
    s = 320
    dense = 2 * s * (4 * 1024 * 1024 + 2 * 1024 * 4096)
    attn = 4 * 16 * s * s * 64
    assert F.encoder_layer(1, s, enc) == dense + attn == 8472494080
    # six FLOPs per weight per token in training, plus attention
    per_token = 3 * F.encoder_layer(1, s, enc) / s
    assert per_token == pytest.approx(6 * 12582912 + 3 * 4 * s * 1024)


def test_the_text_train_step_counts_every_layer_and_the_head():
    cfg = _cfg("roberta-large-heatmap")
    head = F.heatmap_head(64, 5, 1024)
    expect = 3 * (24 * F.encoder_layer(64, 320, cfg["encoder"]) + head)
    assert F.model_flops(cfg, 64, True) == pytest.approx(expect)
    assert F.model_flops(cfg, 64, True) == pytest.approx(39.06e12, rel=1e-3)
    assert F.model_flops(cfg, 32, False) == pytest.approx(
        F.model_forward(cfg, 32))


def test_the_joint_stream_and_the_tower():
    cfg = _cfg("clip-rn50-roberta-large")
    calls = F.attention_calls(cfg, 24, 5)
    # the attention pool over 5 x 7 x 7 + 1 tokens, 32 heads of 64; then
    # 24 joint layers at 320 + 246 = 566
    assert calls[0] == (24, 32, 246, 64)
    assert calls[1:] == [(24, 16, 566, 64)] * 24
    vis = cfg["vision"]
    # the stem's first conv: 3 -> 32 channels, 3 x 3, stride 2 to 112 x 112
    stem1 = 2 * 3 * 32 * 9 * 112 * 112
    assert F._conv(1, 3, 32, 3, 112) == stem1
    tower = F.rn50_tower(5, 1, vis)
    assert 5 * 10e9 < tower < 5 * 14e9  # ~12.3 GFLOP an image and its pool
    with_tower = F.model_forward(cfg, 2, 5)
    text_only = F.model_forward(_cfg("roberta-large-heatmap"), 2)
    assert with_tower > text_only + F.rn50_tower(10, 2, vis)
