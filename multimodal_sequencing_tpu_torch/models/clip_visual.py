"""CLIP visual towers with multi-image ("img_len") folding (counterpart of
`models/clip_visual.py`).

  * `ModifiedResNet` (RN50): 3-conv stem, anti-aliased strided
    `Bottleneck`s, `AttentionPool2d` over the folded stream of a story's N
    step images (their patch tokens behind one mean token, the positional
    embedding repeated per image), its output duplicated channel-wise.
  * `VisualTransformer` (ViT): conv patch embed, pre-LN `ViTBlock`s with
    QuickGELU, the same fold behind one class token; the ViLT mode runs
    text embeddings in front of the patches through the visual stack.
  * `CLIPVisualTower` picks one by `CLIPVisionConfig.model_name`.

Module and parameter names follow the Flax tree (`resnet/layer2_0/conv1`,
`attnpool/q_proj`, `vit/resblock_3/qkv`, ...), so weights move between the
packages by name (`models/convert.py`). Tensors are NCHW here where the JAX
package is NHWC; the fold is defined on NHWC and permutes accordingly. On
the card the trunk runs channels-last (the convs' native cuDNN layout);
that changes memory order, not values.

Dtypes follow Flax: f32 parameters; `Conv` and `Dense` cast input and
weight to the compute dtype; `BatchNorm` reduces in at least f32 and
returns the compute dtype; the ViT's LayerNorms return f32 (Flax `nn.LayerNorm` without
a dtype promotes to its f32 parameters), so the ViT's residual stream is
f32.

`BatchNorm` is Flax's, written over plain torch ops: in training the batch
mean and the *fast* variance max(0, E[x^2] - E[x]^2) in f32, and the
running averages `ra = 0.9 ra + 0.1 batch` of the biased variance; in eval
the running averages; then (x - mean) * (weight * rsqrt(var + 1e-5)) + bias
in f32. (`F.batch_norm` and cuDNN compute the variance otherwise and update
the running variance unbiased.) The convs are `F.conv2d` (cuDNN on the
card); the JAX package leaves them to XLA.

The attention of `AttentionPool2d` and `ViTBlock` goes through
`ops/attention.py::multihead_attention`: the flash kernels on the card, the
plain version on the CPU (which also takes head dims the kernels do not,
such as `tiny_vit`'s 8).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import data_all_reduce, data_size
from .config import CLIPVisionConfig
from .encoder import Dense, LayerNorm
from ..ops.attention import multihead_attention

def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class Conv(nn.Conv2d):
    """Flax `nn.Conv(use_bias=..., dtype=...)` on NCHW: an f32 (out, in,
    kh, kw) weight (and bias); input, weight and bias cast to the compute
    dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 bias: bool = False):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        self.stride, self.padding)


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)` over the
    channels of an NCHW tensor (`weight`/`bias` are Flax's `scale`/`bias`,
    `running_mean`/`running_var` its `batch_stats` `mean`/`var`).
    `deterministic=False` normalizes by the batch statistics and updates
    the running averages once per call; in a data-parallel step the
    statistics are the global batch's (the sum and the sum of squares
    all-reduced over the data group, differentiably)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        # at least f32, as Flax promotes (f64 stays f64)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if deterministic:
            mean, var = self.running_mean, self.running_var
        else:
            if data_size() == 1:
                mean = xf.mean((0, 2, 3))
                var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                                  min=0.0)
            else:
                n = xf.numel() // xf.shape[1] * data_size()
                sums = data_all_reduce(torch.stack(
                    [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]))
                mean = sums[0] / n
                var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.compute_dtype)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x, k, k)  # Flax nn.avg_pool, window = stride


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: every conv stride 1, an average pool
    after conv2 (and on the identity) when stride > 1."""
    EXPANSION = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        out = planes * self.EXPANSION
        self.conv1 = Conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, padding=1, dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = Conv(planes, out, 1, dtype=dtype)
        self.bn3 = BatchNorm(out, dtype)
        self.has_downsample = stride > 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = Conv(inplanes, out, 1, dtype=dtype)
            self.downsample_bn = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        out = F.relu(self.bn1(self.conv1(x), deterministic))
        out = F.relu(self.bn2(self.conv2(out), deterministic))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out), deterministic)
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity),
                                          deterministic)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling over the folded stream. Input (B * img_len, C,
    H, W); with img_len > 1 returns the whole stream (B, img_len * H * W +
    1, 2 * output_dim), channel-duplicated; else the pooled (B,
    output_dim)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.embed_dim, cfg.compute_dtype
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.grid * cfg.grid + 1, c))
        self.q_proj = Dense(c, c, dt)
        self.k_proj = Dense(c, c, dt)
        self.v_proj = Dense(c, c, dt)
        self.c_proj = Dense(c, cfg.output_dim, dt)

    def fold(self, x: torch.Tensor, img_len: int) -> torch.Tensor:
        """(B * L, C, H, W) -> (B, L * H * W, C) tokens. The clean fold takes
        each image's patches in NHWC order; `ref_fold_quirk` replays the
        reference's `x.reshape(B, C, HW * L)` of NCHW memory (channels and
        images interleaved)."""
        bn, c, h, w = x.shape
        b = bn // img_len
        if self.cfg.ref_fold_quirk and img_len > 1:
            return x.reshape(b, c, h * w * img_len).transpose(1, 2)
        return x.permute(0, 2, 3, 1).reshape(b, img_len * h * w, c)

    def forward(self, x: torch.Tensor, img_len: int = 1) -> torch.Tensor:
        cfg = self.cfg
        _, c, h, w = x.shape
        tokens = self.fold(x, img_len)
        b = tokens.shape[0]
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], dim=1)
        pos = self.positional_embedding
        if img_len > 1:
            pos = torch.cat([pos] + [pos[:h * w]] * (img_len - 1), dim=0)
        tokens = tokens + pos[None].to(tokens.dtype)
        length, heads = tokens.shape[1], cfg.heads
        d = c // heads

        def split(t):
            return t.view(b, length, heads, d).transpose(1, 2)

        ctx = multihead_attention(split(self.q_proj(tokens)),
                                  split(self.k_proj(tokens)),
                                  split(self.v_proj(tokens)))
        out = self.c_proj(ctx.transpose(1, 2).reshape(b, length, c))
        if img_len > 1:
            return torch.cat([out, out], dim=-1)
        return out[:, 0]


class ModifiedResNet(nn.Module):
    """CLIP's RN50 trunk and attention pool."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        w, dt = cfg.width, cfg.compute_dtype
        self.conv1 = Conv(3, w // 2, 3, stride=2, padding=1, dtype=dt)
        self.bn1 = BatchNorm(w // 2, dt)
        self.conv2 = Conv(w // 2, w // 2, 3, padding=1, dtype=dt)
        self.bn2 = BatchNorm(w // 2, dt)
        self.conv3 = Conv(w // 2, w, 3, padding=1, dtype=dt)
        self.bn3 = BatchNorm(w, dt)
        self.blocks = []
        inplanes = w
        for stage, (blocks, mult, stride) in enumerate(
                zip(cfg.layers, (1, 2, 4, 8), (1, 2, 2, 2))):
            for blk in range(blocks):
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, Bottleneck(
                    inplanes, w * mult, stride if blk == 0 else 1, dt))
                self.blocks.append(name)
                inplanes = w * mult * Bottleneck.EXPANSION
        self.attnpool = AttentionPool2d(cfg)

    def forward(self, x: torch.Tensor, skip_last_layer: bool = False,
                img_len: int = 1, deterministic: bool = True):
        x = x.to(self.cfg.compute_dtype)
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x), deterministic))
        x = F.relu(self.bn2(self.conv2(x), deterministic))
        x = F.relu(self.bn3(self.conv3(x), deterministic))
        x = _avg_pool(x, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, deterministic)
        if skip_last_layer:
            return x  # (B * L, embed_dim, grid, grid)
        return self.attnpool(x, img_len)


class ViTBlock(nn.Module):
    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        f32 = torch.float32
        self.ln_1 = LayerNorm(width, 1e-5, f32)
        self.qkv = Dense(width, 3 * width, dtype)
        self.attn_out = Dense(width, width, dtype)
        self.ln_2 = LayerNorm(width, 1e-5, f32)
        self.c_fc = Dense(width, 4 * width, dtype)
        self.c_proj = Dense(4 * width, width, dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ln_1(x.float())
        b, length, c = h.shape
        d = c // self.heads

        def split(t):
            return t.view(b, length, self.heads, d).transpose(1, 2)

        q, k, v = self.qkv(h).chunk(3, dim=-1)
        ctx = multihead_attention(split(q), split(k), split(v), mask)
        x = x + self.attn_out(ctx.transpose(1, 2).reshape(b, length, c))
        h = quick_gelu(self.c_fc(self.ln_2(x.float())))
        return x + self.c_proj(h)


class VisualTransformer(nn.Module):
    """CLIP ViT with multi-image folding, and the ViLT joint mode: text
    embeddings in front of the patch stream through the visual stack."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        width, p, dt = cfg.vit_width, cfg.patch_size, cfg.compute_dtype
        f32 = torch.float32
        self.conv1 = Conv(3, width, p, stride=p, dtype=dt)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.grid * cfg.grid + 1, width))
        self.ln_pre = LayerNorm(width, 1e-5, f32)
        for i in range(cfg.vit_layers):
            self.add_module(f"resblock_{i}", ViTBlock(width, cfg.vit_heads, dt))
        self.ln_post = LayerNorm(width, 1e-5, f32)
        self.proj = nn.Parameter(torch.zeros(width, cfg.output_dim))

    def forward(self, x: torch.Tensor, skip_last_layer: bool = False,
                img_len: int = 1, text_embedding: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = self.conv1(x.to(dt))
        bn, c, gh, gw = x.shape
        patch_len = gh * gw
        b = bn // img_len
        x = x.permute(0, 2, 3, 1).reshape(b, img_len * patch_len, c)
        cls = self.class_embedding.to(dt).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        pos = self.positional_embedding
        if img_len > 1:
            pos = torch.cat([pos] + [pos[:patch_len]] * (img_len - 1), dim=0)
        x = self.ln_pre((x + pos[None].to(dt)).float())
        mask = None
        if text_embedding is not None:
            x = torch.cat([text_embedding.to(dt).to(x.dtype), x], dim=1)
            if text_mask is not None:
                ones = torch.ones((b, x.shape[1] - text_mask.shape[1]),
                                  dtype=torch.int32, device=x.device)
                mask = torch.cat([text_mask.to(torch.int32), ones], dim=1)
        for i in range(cfg.vit_layers):
            x = getattr(self, f"resblock_{i}")(x, mask)
        if text_embedding is not None:
            return x
        if skip_last_layer:
            return self.ln_post(x.float())
        out_dt = torch.promote_types(x.dtype, dt)
        return x.to(out_dt) @ self.proj.to(dt).to(out_dt)


class CLIPVisualTower(nn.Module):
    """RN50 or ViT by config: the multimodal encoder's `visual_model`."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.is_resnet:
            self.resnet = ModifiedResNet(cfg)
        else:
            self.vit = VisualTransformer(cfg)

    def forward(self, images: torch.Tensor, skip_last_layer: bool = False,
                img_len: int = 1, deterministic: bool = True) -> torch.Tensor:
        if self.cfg.is_resnet:
            return self.resnet(images, skip_last_layer, img_len, deterministic)
        return self.vit(images, skip_last_layer=skip_last_layer,
                        img_len=img_len, deterministic=deterministic)
