"""BERT/RoBERTa-compatible text encoder, eval mode (counterpart of
`models/encoder.py`).

Learned word/position/type embeddings -> post-LN transformer blocks ->
tanh pooler. `token_type_ids` carry the step index of the packed story, so
`type_vocab_size` is sized to `max_story_length`. Module names follow the
Flax parameter tree (`embeddings`, `layer_{i}`, `pooler`), so weights move
between the two packages by name (`models/convert.py`). Attention runs
through `ops/attention.py::multihead_attention`: the Hopper flash kernel on
the card, its plain version on the CPU. Dropout is not applied: the port
runs the eval forward only so far.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .config import EncoderConfig
from ..ops.attention import multihead_attention
from ..ops.gelu import gelu


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        hs = cfg.hidden_size
        self.query = nn.Linear(hs, hs)
        self.key = nn.Linear(hs, hs)
        self.value = nn.Linear(hs, hs)
        self.out = nn.Linear(hs, hs)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = hidden.shape
        h, d = cfg.num_attention_heads, cfg.head_dim

        def split(x):
            return x.view(b, s, h, d).transpose(1, 2)

        ctx = multihead_attention(split(self.query(hidden)),
                                  split(self.key(hidden)),
                                  split(self.value(hidden)), mask)
        ctx = ctx.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        return self.out(ctx)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        hs, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = SelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(hs, eps=eps)
        self.intermediate = nn.Linear(hs, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, hs)
        self.output_ln = nn.LayerNorm(hs, eps=eps)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        hidden = self.attention_ln(hidden + self.attention(hidden, mask))
        mlp = gelu(self.intermediate(hidden), self.cfg.resolved_gelu_impl)
        return self.output_ln(hidden + self.output(mlp))


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        hs = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, hs)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, hs)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, hs)
        self.ln = nn.LayerNorm(hs, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        return self.ln(x)


class TextEncoder(nn.Module):
    """Embeddings + N post-LN layers + pooler; returns
    (sequence_output, pooled_output)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(cfg))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = attention_mask.to(torch.int32)
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled
