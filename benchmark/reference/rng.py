"""The random draws of a train step, worked out again from the run's seed:
the hidden-dropout masks and the attention-dropout keep bits.

A step's streams are keyed by splitmix64 of (seed + 1, step). Hidden
dropout keeps an element where a Bernoulli(1 - p) draw of the stream's
device generator, over a tensor of the activation's shape and dtype, is
1. The attention's "probs" dropout keeps logit (row, col) of head bh where
the murmur3 fmix32 hash of the counter (row * S + col) * 0x9E3779B9 plus
the head's seed, taken to 31 bits, lies below (1 - p) * (2^31 - 1); the
head's seed is fmix32(layer seed + (bh + 1) * 668265263) and the layer
seed an int32 draw of the stream's host generator.

The text encoder gives layer i a stream of its own, keyed from one host
draw; the multimodal encoder's layers draw in turn from the step's own
streams. The order of draws is listed in `text_draws` and `joint_draws`.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def fold_in(seed: int, step: int) -> int:
    x = ((seed & M32) << 32 | (step & M32)) + 0x9E3779B97F4A7C15
    x &= M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return (x ^ (x >> 31)) >> 1


class Streams:
    """A (device, host) generator pair keyed by (seed, step)."""

    def __init__(self, seed: int, step: int, device):
        key = fold_in(seed, step)
        self.device = torch.Generator(device=device).manual_seed(key)
        self.host = torch.Generator(device="cpu").manual_seed(key)
        self.where = torch.device(device)

    def mask(self, shape, dtype, p: float) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self.where).bernoulli_(
            1.0 - p, generator=self.device).bool()

    def layer_seed(self) -> int:
        return int(torch.randint(-2**31, 2**31 - 1, (), generator=self.host))

    def stream_base(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.host))


def text_draws(seed: int, step: int, device, b: int, s: int, h: int,
               layers: int, p: float, dtype
               ) -> Tuple[torch.Tensor, List[Tuple[int, torch.Tensor,
                                                   torch.Tensor]]]:
    """(embedding mask, [(layer seed, attention-output mask, MLP-output
    mask), ...]) of a text-encoder train step."""
    st = Streams(seed + 1, step, device)
    emb = st.mask((b, s, h), dtype, p)
    base = st.stream_base()
    out = []
    for i in range(layers):
        li = Streams(base, i, device)
        seed_i = li.layer_seed()
        out.append((seed_i, li.mask((b, s, h), dtype, p),
                    li.mask((b, s, h), dtype, p)))
    return emb, out


def joint_draws(seed: int, step: int, device, b: int, s_text: int,
                s_visual: int, h: int, layers: int, p: float, dtype):
    """(embedding mask, visual-projection mask (f32, as the projection's
    LayerNorm returns f32), [(layer seed, attention-output mask, MLP-output
    mask), ...]) of a multimodal train step."""
    st = Streams(seed + 1, step, device)
    emb = st.mask((b, s_text, h), dtype, p)
    vis = st.mask((b, s_visual, h), torch.float32, p)
    out = []
    for _ in range(layers):
        seed_i = st.layer_seed()
        out.append((seed_i, st.mask((b, s_text + s_visual, h), dtype, p),
                    st.mask((b, s_text + s_visual, h), dtype, p)))
    return emb, vis, out


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return ((((hi * c) & 0xFFFF) << 16) + lo * c) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_bits(seed: int, bh: torch.Tensor, s: int, p: float) -> torch.Tensor:
    """(len(bh), S, S) bool keep mask of the global heads `bh` (int64)."""
    thresh = int((1.0 - p) * 2147483647)
    head = fmix32((seed + _mul32((bh + 1) & M32, 668265263)) & M32)
    ar = torch.arange(s, dtype=torch.int64, device=bh.device)
    idx = (ar[:, None] * s + ar[None, :]) & M32
    mixed = _mul32(idx, 0x9E3779B9)[None]
    x = fmix32((mixed + head[:, None, None]) & M32)
    return (x & 0x7FFFFFFF) < thresh
