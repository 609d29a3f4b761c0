"""Operations and bytes of the sequencer's parts, counted from the
configuration's shapes (never from the program's launches).

A matrix product of (t, k) by (k, n) is 2 t k n operations. Training
counts the forward and twice it for the backward; recomputation and
padding rows are not counted. Attention's forward is 4 B H S^2 D (the
two products), its backward 2.5 times that; its bytes are q, k, v and o
(bf16), the log-sum-exp (f32) and the key mask (int32) read or written
once in the forward, and q, k, v, o, dO, dq, dk, dv, the log-sum-exp and
the mask in the backward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOP_PER_S = 989e12   # H100 SXM, dense bf16, data sheet
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, data sheet


def dense(tokens: float, fan_in: int, fan_out: int) -> float:
    return 2.0 * tokens * fan_in * fan_out


def attention_fwd_flops(b, h, s, d) -> float:
    return 4.0 * b * h * s * s * d


def attention_fwd_bytes(b, h, s, d) -> float:
    return 4 * b * h * s * d * 2 + b * h * s * 4 + b * s * 4


def attention_bwd_flops(b, h, s, d) -> float:
    return 2.5 * attention_fwd_flops(b, h, s, d)


def attention_bwd_bytes(b, h, s, d) -> float:
    return 8 * b * h * s * d * 2 + b * h * s * 4 + b * s * 4


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


def encoder_layer(rows: int, s: int, enc: Dict) -> float:
    hs, ff, h = (enc["hidden_size"], enc["intermediate_size"],
                 enc["num_attention_heads"])
    t = rows * s
    return (4 * dense(t, hs, hs) + dense(t, hs, ff) + dense(t, ff, hs)
            + attention_fwd_flops(rows, h, s, hs // h))


def heatmap_head(rows: int, n: int, hs: int) -> float:
    return (2 * dense(rows * n, hs, hs) + 2.0 * rows * n * n * hs
            + dense(rows * n * n, 2 * hs, hs // 2)
            + dense(rows * n * n, hs // 2, 1))


def _conv(images, cin, cout, k, hw) -> float:
    return 2.0 * images * cin * cout * k * k * hw * hw


def rn50_tower(images: int, stories: int, vis: Dict) -> float:
    """The modified ResNet-50 and its attention pool over each story's
    folded stream (`stories` streams of `images / stories` images)."""
    w, r = vis["width"], vis["image_resolution"]
    f = (_conv(images, 3, w // 2, 3, r // 2)
         + _conv(images, w // 2, w // 2, 3, r // 2)
         + _conv(images, w // 2, w, 3, r // 2))
    hw, inplanes = r // 4, w
    for stage, (blocks, mult, stride) in enumerate(
            zip(vis["layers"], (1, 2, 4, 8), (1, 2, 2, 2))):
        for blk in range(blocks):
            planes = w * mult
            st = stride if blk == 0 else 1
            out_hw = hw // st
            f += _conv(images, inplanes, planes, 1, hw)
            f += _conv(images, planes, planes, 3, hw)
            f += _conv(images, planes, planes * 4, 1, out_hw)
            if st > 1 or inplanes != planes * 4:
                f += _conv(images, inplanes, planes * 4, 1, out_hw)
            hw, inplanes = out_hw, planes * 4
    c, g = w * 32, vis["grid"]
    length = (images // stories) * g * g + 1
    t = stories * length
    f += 3 * dense(t, c, c) + dense(t, c, vis["output_dim"])
    f += attention_fwd_flops(stories, vis["heads"], length, c // vis["heads"])
    return f


def model_forward(cfg: Dict, rows: int, images_per_story: int = 0) -> float:
    """One forward over `rows` packed stories (with their step images)."""
    enc, vis = cfg["encoder"], cfg.get("vision")
    s = cfg["max_seq_length"]
    f = heatmap_head(rows, cfg["max_story_length"], enc["hidden_size"])
    if vis is not None and images_per_story:
        s_vis = images_per_story * vis["grid"] ** 2 + 1
        f += rn50_tower(rows * images_per_story, rows, vis)
        f += dense(rows * s_vis, 2 * vis["output_dim"], enc["hidden_size"])
        s += s_vis
    return f + enc["num_hidden_layers"] * encoder_layer(rows, s, enc)


def model_flops(cfg: Dict, rows: int, train: bool,
                images_per_story: int = 0) -> float:
    f = model_forward(cfg, rows, images_per_story)
    return 3.0 * f if train else f


def attention_calls(cfg: Dict, rows: int, images_per_story: int = 0
                    ) -> List[Tuple[int, int, int, int]]:
    """(B, H, S, D) of every attention call of one forward."""
    enc, vis = cfg["encoder"], cfg.get("vision")
    h = enc["num_attention_heads"]
    d = enc["hidden_size"] // h
    s = cfg["max_seq_length"]
    calls = []
    if vis is not None and images_per_story:
        length = images_per_story * vis["grid"] ** 2 + 1
        c = vis["width"] * 32
        calls.append((rows, vis["heads"], length, c // vis["heads"]))
        s += length
    calls += [(rows, h, s, d)] * enc["num_hidden_layers"]
    return calls


def attention_least_seconds(cfg: Dict, rows: int, train: bool,
                            images_per_story: int = 0) -> float:
    """The least time of one step's (or one forward's) attention calls."""
    total = 0.0
    for b, h, s, d in attention_calls(cfg, rows, images_per_story):
        total += least_seconds(attention_fwd_flops(b, h, s, d),
                               attention_fwd_bytes(b, h, s, d))
        if train:
            total += least_seconds(attention_bwd_flops(b, h, s, d),
                                   attention_bwd_bytes(b, h, s, d))
    return total
