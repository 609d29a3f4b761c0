"""The sequencer in plain PyTorch, float32, over a dict of parameters named
as the program's checkpoints name them.

RoBERTa (post-LN layers: attention, residual, LayerNorm, erf GELU MLP,
residual, LayerNorm; learned word, position (offset 2) and step-type
embeddings) with the heat-map head v1 (tanh parent and child projections,
their scaled product plus a tanh-GELU pair MLP, sigmoid), and for the
multimodal sequencer OpenAI CLIP's modified ResNet-50 (three-conv stem,
anti-aliased bottlenecks, Flax-form BatchNorm: batch mean and biased
variance in training, running averages with momentum 0.9, eps 1e-5) whose
attention pool runs over the folded patch stream of a story's step images
(a mean token, the position table repeated per image, output duplicated
channel-wise), then x/y grid positions, per-step types, a projection with
a LayerNorm (eps 1e-12) into the text width, and the text and visual
tokens through the same layers.

Departures from the program, each below rounding at float32: LayerNorm and
BatchNorm take the two-pass variance; the MLP's GELU is the exact erf form
(the program evaluates a fitted logit form of it). `quant`, when given,
rounds the operands of every matrix product, convolution and attention
product (the control's lower precision).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _id(t):
    return t


def linear(P, name, x, q=_id):
    b = P.get(name + ".bias")
    return F.linear(q(x), q(P[name + ".weight"]), b)


def layer_norm(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], eps)


def dropout(x, keep, p):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def attention(q, k, v, key_keep, p=0.0, bits=None, quant=_id):
    """(B, H, S, D) f32 context; `bits` (B, H, S, S) the keep bits."""
    d = q.shape[-1]
    logits = torch.matmul(quant(q), quant(k).transpose(-1, -2)) / math.sqrt(d)
    if key_keep is not None:
        logits = logits.masked_fill(~key_keep[:, None, None, :], -1e9)
    probs = torch.softmax(logits, dim=-1)
    if bits is not None:
        probs = torch.where(bits, probs / (1.0 - p),
                            torch.zeros((), device=q.device))
    return torch.matmul(quant(probs), quant(v))


def encoder_layer(P, i, x, key_keep, ecfg, draw=None, bits_fn=None,
                  quant=_id):
    """One post-LN layer. `draw` = (layer seed, attention-output mask,
    MLP-output mask) in training; `bits_fn(seed, b, h, s)` the layer's
    keep bits for these rows."""
    pre = f"encoder.layer_{i}"
    b, s, hs = x.shape
    h = ecfg["num_attention_heads"]
    d = hs // h
    p_h = ecfg["hidden_dropout_prob"]
    p_a = ecfg["attention_probs_dropout_prob"]

    def split(t):
        return t.view(b, s, h, d).transpose(1, 2)

    q = split(linear(P, pre + ".attention.query", x, quant))
    k = split(linear(P, pre + ".attention.key", x, quant))
    v = split(linear(P, pre + ".attention.value", x, quant))
    bits = None if draw is None or p_a == 0 else bits_fn(draw[0], b, h, s)
    ctx = attention(q, k, v, key_keep, p_a, bits, quant)
    ctx = ctx.transpose(1, 2).reshape(b, s, hs)
    out = linear(P, pre + ".attention.out", ctx, quant)
    out = dropout(out, None if draw is None else draw[1], p_h)
    x = layer_norm(P, pre + ".attention_ln", x + out, ecfg["layer_norm_eps"])
    mlp = F.gelu(linear(P, pre + ".intermediate", x, quant))
    mlp = dropout(linear(P, pre + ".output", mlp, quant),
                  None if draw is None else draw[2], p_h)
    return layer_norm(P, pre + ".output_ln", x + mlp, ecfg["layer_norm_eps"])


def embed_text(P, ids, types, ecfg, keep=None):
    s = ids.shape[1]
    pos = torch.arange(s, device=ids.device) + 2
    pre = "encoder.embeddings."
    x = (F.embedding(ids, P[pre + "word_embeddings.weight"])
         + F.embedding(pos, P[pre + "position_embeddings.weight"])[None]
         + F.embedding(types.clamp(max=ecfg["type_vocab_size"] - 1),
                       P[pre + "token_type_embeddings.weight"]))
    x = layer_norm(P, pre + "ln", x, ecfg["layer_norm_eps"])
    return dropout(x, keep, ecfg["hidden_dropout_prob"])


def step_cls(seq, ids, n_steps: int):
    """(reprs (B, N, H), present (B, N)): the hidden state at each step's
    [cls], the k-th cls token of the row."""
    is_cls = (ids == 0).long()
    rank = torch.cumsum(is_cls, 1) * is_cls
    onehot = rank[:, :, None] == torch.arange(1, n_steps + 1,
                                              device=ids.device)[None, None]
    pos = onehot.long().argmax(1)
    present = onehot.any(1)
    idx = pos[:, :, None].expand(-1, -1, seq.shape[-1])
    return torch.gather(seq, 1, idx), present


def heatmap_head(P, reprs, present, quant=_id):
    b, n, hs = reprs.shape
    parent = torch.tanh(linear(P, "heatmap_head.parent_proj", reprs, quant))
    child = torch.tanh(linear(P, "heatmap_head.child_proj", reprs, quant))
    logits = torch.einsum("bih,bjh->bij", quant(parent), quant(child))
    logits = logits / math.sqrt(hs)
    pi = reprs.repeat_interleave(n, dim=1)
    pj = reprs.repeat(1, n, 1)
    inter = F.gelu(linear(P, "heatmap_head.pair_mlp",
                          torch.cat([pi, pj], -1), quant), approximate="tanh")
    inter = linear(P, "heatmap_head.pair_out", inter, quant)
    logits = logits + inter.reshape(logits.shape)
    valid = present[:, :, None] & present[:, None, :]
    return torch.where(valid, torch.sigmoid(logits),
                       torch.zeros((), device=reprs.device))


def bce_sum(heat, target, present):
    """(sum of the BCE over valid step pairs, their count)."""
    p = heat.abs().clamp(1e-6, 1 - 1e-6)
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    valid = present[:, :, None] & present[:, None, :]
    zero = torch.zeros((), device=heat.device)
    return torch.where(valid, bce, zero).sum(), valid.sum()


# ----- CLIP RN50 -----------------------------------------------------------


def conv(P, name, x, stride=1, padding=0, q=_id):
    return F.conv2d(q(x), q(P[name + ".weight"]), P.get(name + ".bias"),
                    stride, padding)


def batch_norm(P, name, x, train: bool, momentum=0.9, eps=1e-5):
    """Flax BatchNorm over the channels of NCHW `x`; in training it updates
    the running averages in `P` (outside autograd)."""
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        with torch.no_grad():
            rm, rv = P[name + ".running_mean"], P[name + ".running_var"]
            rm.copy_(momentum * rm + (1 - momentum) * mean)
            rv.copy_(momentum * rv + (1 - momentum) * var)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    mul = torch.rsqrt(var + eps) * P[name + ".weight"]
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + P[name + ".bias"][:, None, None]


def _conv_bn(P, name, conv_name, bn_name, x, train, q, padding=0):
    y = conv(P, name + conv_name, x, padding=padding, q=q)
    return batch_norm(P, name + bn_name, y, train)


def _bottleneck(P, name, x, stride, train, q):
    out = F.relu(_conv_bn(P, name, ".conv1", ".bn1", x, train, q))
    out = F.relu(_conv_bn(P, name, ".conv2", ".bn2", out, train, q, 1))
    if stride > 1:
        out = F.avg_pool2d(out, stride, stride)
    out = _conv_bn(P, name, ".conv3", ".bn3", out, train, q)
    identity = x
    if name + ".downsample_conv.weight" in P:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride, stride)
        identity = _conv_bn(P, name, ".downsample_conv", ".downsample_bn",
                            identity, train, q)
    return F.relu(out + identity)


def rn50_tower(P, images_u8, vcfg, train: bool, quant=_id):
    """(B, N, H, W, 3) uint8 step images -> the attention pool's folded
    stream (B, N * g * g + 1, 2 * output_dim)."""
    pre = "encoder.visual_model.resnet"
    b, n = images_u8.shape[:2]
    x = images_u8.reshape((b * n,) + images_u8.shape[2:]).float() / 255.0
    x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
    x = x.permute(0, 3, 1, 2)
    x = F.relu(batch_norm(P, pre + ".bn1",
                          conv(P, pre + ".conv1", x, 2, 1, quant), train))
    x = F.relu(batch_norm(P, pre + ".bn2",
                          conv(P, pre + ".conv2", x, 1, 1, quant), train))
    x = F.relu(batch_norm(P, pre + ".bn3",
                          conv(P, pre + ".conv3", x, 1, 1, quant), train))
    x = F.avg_pool2d(x, 2, 2)
    strides = (1, 2, 2, 2)
    for stage, (blocks, stride) in enumerate(zip(vcfg["layers"], strides)):
        for blk in range(blocks):
            x = _bottleneck(P, f"{pre}.layer{stage + 1}_{blk}", x,
                            stride if blk == 0 else 1, train, quant)
    # attention pool over the folded stream
    ap = pre + ".attnpool"
    _, c, gh, gw = x.shape
    tokens = x.permute(0, 2, 3, 1).reshape(b, n * gh * gw, c)
    tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], 1)
    pos = P[ap + ".positional_embedding"]
    if n > 1:
        pos = torch.cat([pos] + [pos[:gh * gw]] * (n - 1), 0)
    tokens = tokens + pos[None]
    length, heads = tokens.shape[1], vcfg["heads"]
    d = c // heads

    def split(t):
        return t.view(b, length, heads, d).transpose(1, 2)

    ctx = attention(split(linear(P, ap + ".q_proj", tokens, quant)),
                    split(linear(P, ap + ".k_proj", tokens, quant)),
                    split(linear(P, ap + ".v_proj", tokens, quant)), None,
                    quant=quant)
    out = linear(P, ap + ".c_proj", ctx.transpose(1, 2).reshape(b, length, c),
                 quant)
    return torch.cat([out, out], -1)


def visual_tokens(P, feats, n_images: int, grid: int, ecfg, keep=None,
                  quant=_id):
    """The tower's stream with grid positions and step types, projected
    into the text width: (B, N * g * g + 1, hidden)."""
    pre = "encoder"
    ar = torch.arange(grid, device=feats.device)
    xe = F.embedding(ar, P[pre + ".visual_pos.x_position_embedding.weight"])
    ye = F.embedding(ar, P[pre + ".visual_pos.y_position_embedding.weight"])
    pe = (xe[:, None] + ye[None, :]).reshape(1, grid * grid, -1)
    if n_images > 1:
        pe = torch.cat([pe] * n_images, 1)
        pe = torch.cat([pe[:, :1], pe], 1)
    feats = feats + pe
    length = feats.shape[1]
    single = (length - 1) // n_images
    types = torch.cat([
        torch.zeros(1, dtype=torch.long, device=feats.device),
        torch.arange(n_images, device=feats.device).repeat_interleave(single),
        torch.zeros(length - 1 - n_images * single, dtype=torch.long,
                    device=feats.device)])
    feats = feats + F.embedding(
        types, P[pre + ".visual_token_type.token_type_embedding.weight"])[None]
    x = linear(P, pre + ".visn_fc.visn_fc", feats, quant)
    x = layer_norm(P, pre + ".visn_fc.visn_ln", x, 1e-12)
    return dropout(x, keep, ecfg["hidden_dropout_prob"])


def heatmaps(P, batch: Dict[str, torch.Tensor], cfg: Dict,
             visual: Optional[torch.Tensor] = None,
             masks=None, bits_fn: Optional[Callable] = None, quant=_id):
    """Heat maps (B, N, N) and step presence of packed rows; `visual` the
    projected visual tokens of these rows (multimodal), `masks` the step's
    draws for these rows (training): (embedding mask, [(seed, mask,
    mask)])."""
    ecfg = cfg["encoder"]
    ids = batch["input_ids"]
    emb_keep = None if masks is None else masks[0]
    x = embed_text(P, ids, batch["token_type_ids"], ecfg, emb_keep)
    key_keep = batch["attention_mask"].bool()
    if visual is not None:
        x = torch.cat([x, visual], 1)
        key_keep = torch.cat([key_keep, torch.ones(visual.shape[:2],
                                                   dtype=torch.bool,
                                                   device=ids.device)], 1)
    for i in range(ecfg["num_hidden_layers"]):
        draw = None if masks is None else masks[1][i]
        x = encoder_layer(P, i, x, key_keep, ecfg, draw, bits_fn, quant)
    seq = x[:, :ids.shape[1]]
    reprs, present = step_cls(seq, ids, cfg["max_story_length"])
    return heatmap_head(P, reprs, present, quant), present


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), straight through in the backward."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    r = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (r - t.detach())
