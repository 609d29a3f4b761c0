"""BERT/RoBERTa-compatible text encoder (counterpart of `models/encoder.py`).

Learned word/position/type embeddings -> post-LN transformer blocks ->
tanh pooler. `token_type_ids` carry the step index of the packed story, so
`type_vocab_size` is sized to `max_story_length`. Module names follow the
Flax parameter tree (`embeddings`, `layer_{i}`, `pooler`), so weights move
between the two packages by name (`models/convert.py`).

Dtypes follow Flax's `dtype=`: parameters stay f32; `Dense` and `Embed` cast
their inputs and weights to the compute dtype (`EncoderConfig.dtype`), and
`LayerNorm` reduces in f32 and returns the compute dtype. Attention
(`ops/attention.py::multihead_attention`), the logit_erf GELU
(`ops/gelu.py`) and the LayerNorm (`ops/layer_norm.py`) run as hand-written
kernels on the card and as their plain versions on the CPU.

Train mode (`deterministic=False`) takes a `DropoutRng`: hidden dropout at
the embeddings, the attention output and the MLP output, drawn from its
device generator, and the HF "probs" attention dropout fused into the flash
kernels, one int32 seed per layer drawn from its host generator
(`attention_dropout_mode="folded"` skips the probs dropout). A deliberate
difference to the JAX package: at S < 512 the JAX encoder trains through its
XLA probs path with JAX's random bits, the port through its kernels with the
hash bits at every S, so the masks never match; parity runs at dropout 0.

`EncoderConfig.remat` recomputes each layer in the backward
(`torch.utils.checkpoint`) instead of keeping its activations. The
recompute replays the layer's randomness: it draws from a copy of the
`DropoutRng` taken before the layer ran (`DropoutRng.fork`), so it makes
the same hidden-dropout masks and the same attention seed, whose keep bits
the flash backward regenerates, while the step's own streams go on as
without remat.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import EncoderConfig
from ..ops.attention import multihead_attention
from ..ops.gelu import gelu
from ..ops.layer_norm import layer_norm


class DropoutRng:
    """The random streams of one train step: `device` draws hidden-dropout
    masks on the model's device, `host` draws the attention kernels' int32
    seeds on the CPU (no device sync). Both are seeded from (seed, step), as
    the JAX step folds the step into its `PRNGKey(seed)`."""

    def __init__(self, seed: int, step: int, device):
        key = fold_in(seed, step)
        self.device = torch.Generator(device=device).manual_seed(key)
        self.host = torch.Generator(device="cpu").manual_seed(key)

    def attention_seed(self) -> int:
        return int(torch.randint(-2**31, 2**31 - 1, (), generator=self.host))

    def fork(self) -> "DropoutRng":
        """A copy with generators of its own that draws what this one would
        draw next; drawing from either leaves the other as it was."""
        new = object.__new__(DropoutRng)
        new.device = torch.Generator(device=self.device.device)
        new.device.set_state(self.device.get_state())
        new.host = torch.Generator(device="cpu")
        new.host.set_state(self.host.get_state())
        return new


def check_rng(deterministic: bool, rng: Optional[DropoutRng]
              ) -> Optional[DropoutRng]:
    """The dropout streams a forward uses: none when `deterministic`; a
    train-mode forward must be given them."""
    if deterministic:
        return None
    if rng is None:
        raise ValueError("deterministic=False needs a DropoutRng")
    return rng


def fold_in(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step): splitmix64 of the pair."""
    x = ((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 31)) >> 1


def dropout(x: torch.Tensor, p: float, rng: Optional[DropoutRng]):
    """Flax `nn.Dropout`: where(keep, x / (1 - p), 0), mask from `rng`;
    the identity when `rng` is None (deterministic) or p == 0."""
    if rng is None or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p,
                                          generator=rng.device).bool()
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dense(nn.Linear):
    """Flax `nn.Dense(dtype=..., use_bias=...)`: f32 (out, in) weight and
    bias; input, weight and bias are cast to the compute dtype for the
    product."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Embed(nn.Embedding):
    """Flax `nn.Embed(dtype=...)`: an f32 table, rows returned in the
    compute dtype."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num, features)
        self.compute_dtype = dtype

    def forward(self, ids):
        return super().forward(ids).to(self.compute_dtype)


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm` (0.12 defaults, `use_fast_variance=True`,
    `force_float32_reductions=True`): f32 mean and E[x^2] - mean^2 clamped
    at 0, (x - mean) * rsqrt(var + eps) * weight + bias in f32, output in
    the compute dtype (`ops/layer_norm.py`: a fused kernel on the card).
    `weight`/`bias` are the Flax `scale`/`bias`."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps,
                          self.compute_dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        hs, dt = cfg.hidden_size, cfg.compute_dtype
        self.query = Dense(hs, hs, dt)
        self.key = Dense(hs, hs, dt)
        self.value = Dense(hs, hs, dt)
        self.out = Dense(hs, hs, dt)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = hidden.shape
        h, d = cfg.num_attention_heads, cfg.head_dim

        def split(x):
            return x.view(b, s, h, d).transpose(1, 2)

        p = cfg.attention_probs_dropout_prob
        if rng is None or cfg.attention_dropout_mode != "probs" or p == 0.0:
            p, seed = 0.0, None
        else:
            seed = rng.attention_seed()
        ctx = multihead_attention(split(self.query(hidden)),
                                  split(self.key(hidden)),
                                  split(self.value(hidden)), mask, p, seed)
        ctx = ctx.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        return dropout(self.out(ctx), cfg.hidden_dropout_prob, rng)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        hs, eps, dt = cfg.hidden_size, cfg.layer_norm_eps, cfg.compute_dtype
        self.attention = SelfAttention(cfg)
        self.attention_ln = LayerNorm(hs, eps, dt)
        self.intermediate = Dense(hs, cfg.intermediate_size, dt)
        self.output = Dense(cfg.intermediate_size, hs, dt)
        self.output_ln = LayerNorm(hs, eps, dt)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        hidden = self.attention_ln(hidden + self.attention(hidden, mask, rng))
        mlp = gelu(self.intermediate(hidden), self.cfg.resolved_gelu_impl)
        mlp = dropout(self.output(mlp), self.cfg.hidden_dropout_prob, rng)
        return self.output_ln(hidden + mlp)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        hs, dt = cfg.hidden_size, cfg.compute_dtype
        self.word_embeddings = Embed(cfg.vocab_size, hs, dt)
        self.position_embeddings = Embed(cfg.max_position_embeddings, hs, dt)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = Embed(cfg.type_vocab_size, hs, dt)
        self.ln = LayerNorm(hs, cfg.layer_norm_eps, dt)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        cfg = self.cfg
        s = input_ids.shape[1]
        # RoBERTa-style positions offset past the pad id, not HF's
        # pad-aware ids: the same as the JAX package
        position_ids = torch.arange(s, device=input_ids.device) + cfg.position_offset
        x = self.word_embeddings(input_ids) + self.position_embeddings(position_ids)[None]
        if cfg.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            token_type_ids = token_type_ids.clamp(max=cfg.type_vocab_size - 1)
            x = x + self.token_type_embeddings(token_type_ids)
        return dropout(self.ln(x), cfg.hidden_dropout_prob, rng)


class TextEncoder(nn.Module):
    """Embeddings + N post-LN layers + pooler; returns
    (sequence_output, pooled_output)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(cfg))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, cfg.compute_dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        rng = check_rng(deterministic, rng)
        x = self.embeddings(input_ids, token_type_ids, rng)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = attention_mask.to(torch.int32)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.cfg.num_hidden_layers):
            layer = getattr(self, f"layer_{i}")
            x = (remat_layer(layer, x, mask, rng) if remat
                 else layer(x, mask, rng))
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


def remat_layer(layer: TransformerLayer, x: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRng]) -> torch.Tensor:
    """`layer(x, mask, rng)` whose activations are recomputed in the
    backward. The first call draws from `rng` as a plain call does; every
    recompute draws from a fresh fork of `rng` as it stood before the
    layer. The layer draws nothing from the global generators, so their
    states are not stashed (`preserve_rng_state=False`)."""
    replay = None if rng is None else rng.fork()
    calls = [0]

    def run(h):
        calls[0] += 1
        r = rng if calls[0] == 1 or replay is None else replay.fork()
        return layer(h, mask, r)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
