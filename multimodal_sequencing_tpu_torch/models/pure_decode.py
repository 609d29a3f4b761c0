"""pure_decode: the text encoder and a one-layer index-token decoder with a
beam-5 generate (counterpart of `models/pure_decode.py`).

The decoder's vocabulary is the N = `max_story_length` step indices, START
(= N) and PAD (N + 1). Its one layer is a causal self-attention, a
cross-attention on the encoder's sequence output (its key mask the
encoder's attention mask) and a tanh-GELU feed-forward (Flax `nn.gelu`'s
default), each followed by a LayerNorm (eps 1e-6, f32), then `lm_head`
(f32). The attentions have the encoder's heads and run in its compute
dtype; they are Flax `MultiHeadDotProductAttention` layers, XLA in the JAX
package, so plain torch here (`models/heads.py::MultiHeadAttention`): the
causal and cross masks are not the flash kernels' key mask. The encoder
runs through the kernels, once a batch, also in `generate`, whose beam
loop runs the decoder alone.

The JAX package's three documented deviations from the reference are kept:
teacher forcing is shifted (decoder input [START] + labels[:-1]); START is
the id N, not the decoder pad 0; `generate` returns the N real index
tokens.

`generate` is HF's beam search as the JAX package computes it: W beams a
story folded into the batch, all N steps (no EOS), the bigram ban
*assigning* -1e9 to a token that would repeat a bigram of its beam, and
the top W of the W x V candidates by a stable descending sort: the W - 1
dead beams start at -1e9, so their candidates tie exactly in f32, and
`lax.top_k` takes the lower index first (torch's `topk` promises no order
among ties). Nothing in it syncs with the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import MultimodalConfig
from .encoder import Dense, DropoutRng, Embed, LayerNorm, TextEncoder
from .heads import MultiHeadAttention, log_softmax

NEG_INF = -1e9


class EncoderIndexDecoder(nn.Module):
    """The text encoder + a one-layer causal index-token decoder with
    cross-attention on the encoder's sequence output. Module names are the
    Flax tree's (`encoder`, `tok_emb`, `pos_emb`, `self_attn`, `ln1`,
    `cross_attn`, `ln2`, `ffn_in`, `ffn_out`, `ln3`, `lm_head`)."""

    def __init__(self, cfg: MultimodalConfig):
        super().__init__()
        self.cfg = cfg
        ecfg = cfg.encoder
        h, dt, n = ecfg.hidden_size, ecfg.compute_dtype, cfg.max_story_length
        heads = ecfg.num_attention_heads
        self.encoder = TextEncoder(ecfg)
        self.tok_emb = Embed(self.index_vocab, h, dt)
        self.pos_emb = nn.Parameter(torch.zeros(n + 1, h))
        self.normal_init = {"pos_emb": 0.02}  # init_weights
        self.self_attn = MultiHeadAttention(h, heads, dt)
        self.ln1 = LayerNorm(h, 1e-6)
        self.cross_attn = MultiHeadAttention(h, heads, dt)
        self.ln2 = LayerNorm(h, 1e-6)
        self.ffn_in = Dense(h, 4 * h, dt)
        self.ffn_out = Dense(4 * h, h, dt)
        self.ln3 = LayerNorm(h, 1e-6)
        self.lm_head = Dense(h, self.index_vocab)

    @property
    def index_vocab(self) -> int:
        return self.cfg.max_story_length + 2

    @property
    def start_id(self) -> int:
        return self.cfg.max_story_length

    def _decoder_logits(self, dec_tokens: torch.Tensor, enc_seq: torch.Tensor,
                        enc_mask: torch.Tensor) -> torch.Tensor:
        """dec_tokens (B, T) -> (B, T, V) f32 logits."""
        b, t = dec_tokens.shape
        x = self.tok_emb(dec_tokens) + self.pos_emb[None, :t].to(
            self.tok_emb.compute_dtype)
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).tril()[None].expand(b, t, t)
        x = self.ln1((x + self.self_attn(x, causal)).float())
        x = self.ln2(x + self.cross_attn(x, enc_mask.bool(), kv=enc_seq))
        ffn = F.gelu(self.ffn_in(x), approximate="tanh")
        x = self.ln3(x + self.ffn_out(ffn))
        return self.lm_head(x).float()

    def _encode(self, input_ids, attention_mask, token_type_ids,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        seq, pooled = self.encoder(input_ids, attention_mask, token_type_ids,
                                   deterministic, rng)
        return seq, pooled, attention_mask

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                images: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None,
                order_labels: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The encoder's outputs and the decoder's `dec_logits` (B, N, V),
        teacher-forced by `order_labels` shifted right behind START (all
        START without labels)."""
        if images is not None:
            raise NotImplementedError(
                "pure_decode is text-only (multimodal not implemented in the "
                "reference either)")
        seq, pooled, mask = self._encode(input_ids, attention_mask,
                                         token_type_ids, deterministic, rng)
        n, b = self.cfg.max_story_length, input_ids.shape[0]
        dec_in = torch.full((b, n), self.start_id, dtype=torch.long,
                            device=input_ids.device)
        if order_labels is not None:
            dec_in[:, 1:] = order_labels[:, :n - 1]
        return {"sequence_output": seq, "pooled_output": pooled,
                "dec_logits": self._decoder_logits(dec_in, seq, mask)}

    def prefix_logits(self, input_ids, attention_mask, token_type_ids,
                      dec_tokens) -> torch.Tensor:
        """The decoder's last-position logits for an explicit prefix."""
        seq, _, mask = self._encode(input_ids, attention_mask,
                                    token_type_ids)
        return self._decoder_logits(dec_tokens, seq, mask)[:, -1]

    def encode(self, input_ids, attention_mask=None, token_type_ids=None):
        """(encoder sequence output, attention mask) for `generate`."""
        seq, _, mask = self._encode(input_ids, attention_mask,
                                    token_type_ids)
        return seq, mask

    @torch.no_grad()
    def generate(self, input_ids, attention_mask=None, token_type_ids=None,
                 num_beams: int = 5, no_repeat_ngram_size: int = 2,
                 enc=None) -> torch.Tensor:
        """Beam search over the index tokens: (B, N) int64, the best
        beam's tokens after START. `enc`: `encode(...)`'s output, when the
        caller has it."""
        enc_seq, mask = enc if enc is not None else self.encode(
            input_ids, attention_mask, token_type_ids)
        b = enc_seq.shape[0]
        n, v, w = self.cfg.max_story_length, self.index_vocab, num_beams
        dev = enc_seq.device
        enc_rep = enc_seq.repeat_interleave(w, dim=0)      # (B*W, S, H)
        mask_rep = mask.repeat_interleave(w, dim=0)
        tokens = torch.full((b, w, n + 1), self.start_id, dtype=torch.long,
                            device=dev)
        scores = torch.full((b, w), NEG_INF, device=dev)
        scores[:, 0] = 0.0
        for t in range(n):
            prefix = tokens[:, :, :t + 1].reshape(b * w, t + 1)
            logp = log_softmax(self._decoder_logits(
                prefix, enc_rep, mask_rep)[:, -1])          # (B*W, V)
            if no_repeat_ngram_size == 2 and t >= 1:
                # ban x where (prefix[t], x) already occurred as a bigram
                last = prefix[:, t]
                for j in range(t):
                    ban = ((prefix[:, j] == last)[:, None]
                           & F.one_hot(prefix[:, j + 1], v).bool())
                    logp = torch.where(ban, NEG_INF, logp)
            total = (scores.reshape(b * w, 1) + logp).reshape(b, w * v)
            # the top W, ties to the lower index (`lax.top_k`'s order)
            top, idx = torch.sort(total, dim=1, descending=True, stable=True)
            scores, idx = top[:, :w], idx[:, :w]
            tokens = torch.gather(tokens, 1, (idx // v)[:, :, None].expand(
                b, w, n + 1)).clone()
            tokens[:, :, t + 1] = idx % v
        return tokens[:, 0, 1:]
