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

Under tensor parallelism (`parallel/sharding_rules.py::parallelize`) a
layer holds its rank's heads and MLP columns and its `tp` (a
`parallel/mesh.py::ModelGroup`): the attention runs at the local head
count, the row-split products are reduced over the model group, and with
`sequence_parallel` the residual, dropout and LayerNorm regions after
`attention_ln` and `output_ln` run on the rank's S / model_size tokens, as
the JAX layer places its `seq_shard` constraints. A layer takes and
returns the whole sequence, so any stack of them runs unchanged. Every
dropout mask and attention keep bit is the one the single-process step
over the global batch draws for that element (`dropout`, the attention's
global head index), so tensor-parallel replicas agree and data-parallel
ranks differ.

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
from ..parallel.mesh import row_slice


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


def dropout(x: torch.Tensor, p: float, rng: Optional[DropoutRng],
            seq: Optional[Tuple[int, int]] = None):
    """Flax `nn.Dropout`: where(keep, x / (1 - p), 0), mask from `rng`;
    the identity when `rng` is None (deterministic) or p == 0. In a
    data-parallel step, or on a sequence-parallel chunk (`seq` = (rank,
    size) of dim 1), the mask is drawn at the global shape and sliced, so
    each element is kept as in the single-process step."""
    if rng is None or p == 0.0:
        return x
    off, rows = row_slice(x.shape[0])
    if rows == x.shape[0] and seq is None:
        keep = torch.empty_like(x)
    else:
        shape = list(x.shape)
        shape[0] = rows
        if seq is not None:
            shape[1] *= seq[1]
        keep = x.new_empty(shape)
    keep = keep.bernoulli_(1.0 - p, generator=rng.device).bool()
    if keep.shape != x.shape:
        keep = keep[off:off + x.shape[0]]
        if seq is not None:
            keep = keep.narrow(1, seq[0] * x.shape[1], x.shape[1])
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
        self.tp = None  # a ModelGroup under tensor parallelism
        hs, dt = cfg.hidden_size, cfg.compute_dtype
        self.query = Dense(hs, hs, dt)
        self.key = Dense(hs, hs, dt)
        self.value = Dense(hs, hs, dt)
        self.out = Dense(hs, hs, dt)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRng] = None,
                seq_parallel: bool = False) -> torch.Tensor:
        """The attention block's output before the residual; under
        `seq_parallel` this rank's sequence chunk of it."""
        cfg, tp = self.cfg, self.tp
        b, s, _ = hidden.shape
        x = hidden if tp is None else tp.copy_in(hidden)
        q, k, v = self.query(x), self.key(x), self.value(x)
        # the local projection's heads: all of them, or this rank's
        d = cfg.head_dim
        h = q.shape[-1] // d

        def split(t):
            return t.view(b, s, h, d).transpose(1, 2)

        p = cfg.attention_probs_dropout_prob
        if rng is None or cfg.attention_dropout_mode != "probs" or p == 0.0:
            p, seed = 0.0, None
        else:
            seed = rng.attention_seed()
        b_off, _ = row_slice(b)
        index = None
        if b_off or tp is not None:
            n_model, m_rank = (1, 0) if tp is None else (tp.size, tp.rank)
            index = (b_off, m_rank * h, h * n_model)
        ctx = multihead_attention(split(q), split(k), split(v), mask, p, seed,
                                  index)
        ctx = ctx.transpose(1, 2).reshape(b, s, h * d)
        if tp is None:
            return dropout(self.out(ctx), cfg.hidden_dropout_prob, rng)
        out, seq = row_parallel(self.out, ctx, tp, seq_parallel)
        return dropout(out, cfg.hidden_dropout_prob, rng, seq)


def row_parallel(dense: Dense, x: torch.Tensor, tp, seq_parallel: bool):
    """A row-split product on the model group: this rank's partial product,
    summed over the group (reduce-scattered over the sequence under
    `seq_parallel`), plus the bias, which then joins the model group's
    gradient sum. Returns (output, the `seq` of `dropout`)."""
    dt = dense.compute_dtype
    y = F.linear(x.to(dt), dense.weight.to(dt))
    if seq_parallel:
        return (tp.reduce_scatter_seq(y) + tp.copy_in(dense.bias).to(dt),
                (tp.rank, tp.size))
    return tp.reduce_out(y) + dense.bias.to(dt), None


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tp = None  # a ModelGroup under tensor parallelism
        hs, eps, dt = cfg.hidden_size, cfg.layer_norm_eps, cfg.compute_dtype
        self.attention = SelfAttention(cfg)
        self.attention_ln = LayerNorm(hs, eps, dt)
        self.intermediate = Dense(hs, cfg.intermediate_size, dt)
        self.output = Dense(cfg.intermediate_size, hs, dt)
        self.output_ln = LayerNorm(hs, eps, dt)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if self.tp is not None:
            return self._forward_tp(hidden, mask, rng)
        hidden = self.attention_ln(hidden + self.attention(hidden, mask, rng))
        mlp = gelu(self.intermediate(hidden), self.cfg.resolved_gelu_impl)
        mlp = dropout(self.output(mlp), self.cfg.hidden_dropout_prob, rng)
        return self.output_ln(hidden + mlp)

    def _forward_tp(self, hidden, mask, rng):
        """The layer on the model group (module docstring); the same
        arithmetic as `forward`."""
        tp, cfg = self.tp, self.cfg
        sp = tp.shards_sequence(hidden.shape[1])
        attn = self.attention(hidden, mask, rng, sp)
        res = tp.scatter_seq(hidden) if sp else hidden
        hidden = self._ln(self.attention_ln, res + attn, sp)
        x = tp.gather_seq(hidden, partial=True) if sp else tp.copy_in(hidden)
        mlp = gelu(self.intermediate(x), cfg.resolved_gelu_impl)
        mlp, seq = row_parallel(self.output, mlp, tp, sp)
        mlp = dropout(mlp, cfg.hidden_dropout_prob, rng, seq)
        out = self._ln(self.output_ln, hidden + mlp, sp)
        return tp.gather_seq(out, partial=False) if sp else out

    def _ln(self, ln: LayerNorm, x, sp: bool):
        """`ln(x)`; on a sequence chunk its parameters' gradients are
        partial sums, summed over the model group."""
        if not sp:
            return ln(x)
        return layer_norm(x, self.tp.copy_in(ln.weight),
                          self.tp.copy_in(ln.bias), ln.eps, ln.compute_dtype)


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
