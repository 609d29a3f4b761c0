"""Detectron2-style ResNet-FPN vision tower with ROI features (counterpart of
`models/fpn.py`).

  * backbone-only mode (`num_regional_features=None`): the FPN's p6 map,
    2x2 average-pooled first with `pool_full_img` (skipped where p6 is 1x1),
    flattened to (B, -1);
  * regional mode (K set): a class-agnostic objectness head (3x3 conv, 1x1
    logit) over p2..p5 scores every cell; the top K cells over all levels
    (a stable descending sort: the lower index first on ties, as
    `lax.top_k`) become fixed squares of 8 x stride around their centres;
    `roi_align` pools each box from p2; the box head (`box_fc1`, `box_fc2`,
    ReLU) gives (B, K, feature_dim) regional features, returned with the
    full-image feature, the scores and the boxes.

Tensors are NCHW where the JAX package is NHWC, so every map is permuted to
(H, W, C) before it is flattened (p6, the ROI features entering `box_fc1`),
which keeps the Flax Dense kernels' row order. The top-down pathway's
upsampling is JAX's `nearest` resize, half-pixel centres: source index
floor((i + 0.5) * in / out) in f32 (torch's `nearest` differs wherever a
level is not exactly twice the next). `roi_align` and the proposal picking
are plain torch, as they are XLA in the JAX package; its sample
coordinates and weights stay f32 under a bf16 map, only the gathered
values carry the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .clip_visual import Conv
from .encoder import Dense
from .resnet import _SPECS, ResNetBackbone

# the levels the proposals and ROI pooling use, with their strides
_LEVEL_STRIDES = (("p2", 4), ("p3", 8), ("p4", 16), ("p5", 32))


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """JAX's `nearest` resize source indices along one axis."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
    return torch.floor(pos * n_in / n_out).long()


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w), as JAX's `nearest` image resize."""
    h, w = size
    if x.shape[2] != h:
        x = x.index_select(2, _nearest_index(x.shape[2], h, x.device))
    if x.shape[3] != w:
        x = x.index_select(3, _nearest_index(x.shape[3], w, x.device))
    return x


class FPN(nn.Module):
    """Lateral 1x1 convs + top-down pathway + 3x3 output convs -> p2..p6
    (p6: p5 subsampled by 2, a 1x1 max pool of stride 2)."""

    def __init__(self, in_channels, out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral_c{i + 2}", Conv(
                cin, out_channels, 1, 1, 0, dtype, bias=True))
            self.add_module(f"output_p{i + 2}", Conv(
                out_channels, out_channels, 3, 1, 1, dtype, bias=True))

    def forward(self, stages: Dict[str, torch.Tensor]):
        laterals = [getattr(self, f"lateral_c{i}")(stages[f"c{i}"])
                    for i in (2, 3, 4, 5)]
        merged = [None] * 4
        merged[3] = laterals[3]
        for i in (2, 1, 0):
            merged[i] = laterals[i] + resize_nearest(
                merged[i + 1], laterals[i].shape[2:])
        outs = {f"p{i + 2}": getattr(self, f"output_p{i + 2}")(merged[i])
                for i in range(4)}
        outs["p6"] = F.max_pool2d(outs["p5"], 1, 2)
        return outs


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7) -> torch.Tensor:
    """Bilinear ROI-align of an (B, H, W, C) map at normalized [0, 1]
    boxes (B, K, 4) as (y0, x0, y1, x1): (B, K, s, s, C), the sample
    coordinates and weights in f32, the values in the map's dtype."""
    b, h, w, _ = feat.shape
    s = output_size
    boxes = boxes.float()
    frac = (torch.arange(s, dtype=torch.float32, device=feat.device)
            + 0.5) / s
    y0, x0, y1, x1 = (boxes[..., i:i + 1] for i in range(4))
    ys = torch.clamp((y0 + frac * (y1 - y0)) * h - 0.5, 0.0, h - 1.0)
    xs = torch.clamp((x0 + frac * (x1 - x0)) * w - 0.5, 0.0, w - 1.0)
    y_lo = torch.clamp(torch.floor(ys).long(), 0, h - 2)
    x_lo = torch.clamp(torch.floor(xs).long(), 0, w - 2)
    wy = (ys - y_lo.float())[..., :, None, None].to(feat.dtype)
    wx = (xs - x_lo.float())[..., None, :, None].to(feat.dtype)
    bidx = torch.arange(b, device=feat.device)[:, None, None, None]

    def g(dy, dx):  # (B, K, s, s, C)
        return feat[bidx, (y_lo + dy)[..., :, None], (x_lo + dx)[..., None, :]]

    return ((1 - wy) * (1 - wx) * g(0, 0) + (1 - wy) * wx * g(0, 1)
            + wy * (1 - wx) * g(1, 0) + wy * wx * g(1, 1))


class FPNVisionTower(nn.Module):
    """ResNet-FPN backbone (`bottom_up`, `fpn`) with Detectron2Wrapper-style
    outputs: flattened (pooled) p6 without `num_regional_features`; with K,
    (full-image features (B, Df), regional (B, K, feature_dim), scores
    (B, K) f32, boxes (B, K, 4) f32). The objectness and box heads exist
    only in regional mode, as in the Flax tree."""

    def __init__(self, backbone_name: str = "resnet50",
                 fpn_channels: int = 256, feature_dim: int = 2048,
                 num_regional_features: Optional[int] = None,
                 roi_size: int = 7, pool_full_img: bool = True,
                 stride_in_1x1: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_regional_features = num_regional_features
        self.roi_size = roi_size
        self.pool_full_img = pool_full_img
        block_cls = _SPECS[backbone_name][0]
        self.bottom_up = ResNetBackbone(backbone_name, dtype, stride_in_1x1)
        self.fpn = FPN([p * block_cls.EXPANSION for p in (64, 128, 256, 512)],
                       fpn_channels, dtype)
        if num_regional_features is not None:
            self.obj_conv = Conv(fpn_channels, fpn_channels, 3, 1, 1, dtype,
                                 bias=True)
            self.obj_logit = Conv(fpn_channels, 1, 1, 1, 0, dtype, bias=True)
            self.box_fc1 = Dense(roi_size * roi_size * fpn_channels,
                                 feature_dim, dtype)
            self.box_fc2 = Dense(feature_dim, feature_dim, dtype)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                 regional: bool = True):
        """`regional=False` runs a regional tower in backbone-only mode."""
        feats = self.fpn(self.bottom_up(images, deterministic,
                                        return_stages=True))
        if self.num_regional_features is None or not regional:
            return self._full_img(feats["p6"])
        b = images.shape[0]
        img_h, img_w = images.shape[2:]
        dev = images.device
        scores, centers, sides = [], [], []
        for name, stride in _LEVEL_STRIDES:
            logit = self.obj_logit(F.relu(self.obj_conv(feats[name])))[:, 0]
            hl, wl = logit.shape[1:]
            scores.append(logit.reshape(b, hl * wl).float())
            yy, xx = torch.meshgrid(torch.arange(hl, device=dev),
                                    torch.arange(wl, device=dev),
                                    indexing="ij")
            cy = (yy.reshape(-1) + 0.5) * stride / img_h
            cx = (xx.reshape(-1) + 0.5) * stride / img_w
            centers.append(torch.stack([cy, cx], -1))
            sides.append(torch.stack([
                torch.full_like(cy, 4.0 * stride / img_h),
                torch.full_like(cx, 4.0 * stride / img_w)], -1))
        all_scores = torch.cat(scores, 1)                   # (B, A)
        order = torch.sort(all_scores, dim=1, descending=True, stable=True)
        k = self.num_regional_features
        top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
        c = torch.cat(centers, 0)[top_idx]                  # (B, K, 2)
        sd = torch.cat(sides, 0)[top_idx]
        boxes = torch.clamp(torch.cat([c - sd, c + sd], -1), 0.0, 1.0)
        rois = roi_align(feats["p2"].permute(0, 2, 3, 1), boxes,
                         self.roi_size)                     # (B, K, s, s, C)
        x = F.relu(self.box_fc1(rois.reshape(b, k, -1)))
        regional = F.relu(self.box_fc2(x))
        return self._full_img(feats["p6"]), regional, top_scores, boxes

    def _full_img(self, p6: torch.Tensor) -> torch.Tensor:
        if self.pool_full_img and min(p6.shape[2:]) >= 2:
            p6 = F.avg_pool2d(p6, 2, 2)
        return p6.permute(0, 2, 3, 1).reshape(p6.shape[0], -1)  # NHWC


def backbone_from_name(vision_model: str) -> str:
    """The FPN's bottom-up ResNet from a detectron2-style config name
    ('detectron2_..._R_101_...' -> resnet101; resnet50 by default)."""
    for tag, name in (("101", "resnet101"), ("50", "resnet50"),
                      ("34", "resnet34"), ("18", "resnet18")):
        if tag in vision_model:
            return name
    return "resnet50"


def is_detectron2(vision_model: str) -> bool:
    return str(vision_model).startswith("detectron2")


def build_pooled_vision_tower(vision_model: str,
                              dtype: torch.dtype) -> nn.Module:
    """`--vision_model` -> a pooled-feature tower: resnet18/34/50/101 the
    global-average ResNet, detectron2_* the FPN tower's flattened p6."""
    if is_detectron2(vision_model):
        return FPNVisionTower(backbone_from_name(vision_model), dtype=dtype)
    return ResNetBackbone(vision_model, dtype)


def full_img_feature_dim(image_size, pool_full_img: bool,
                         fpn_channels: int = 256) -> int:
    """The width of the FPN tower's full-image feature at `image_size`
    (H, W): its channels over p6's cells, 2x2-pooled with `pool_full_img`
    where p6 is at least 2x2."""
    def down(n):
        # conv1 (7x7, stride 2), the stem's max pool, the three stride-2
        # stages and p6's 1x1 pool of stride 2 each give (n - 1) // 2 + 1
        for _ in range(6):
            n = (n - 1) // 2 + 1
        return n

    ph, pw = down(image_size[0]), down(image_size[1])
    if pool_full_img and min(ph, pw) >= 2:
        ph, pw = ph // 2, pw // 2
    return fpn_channels * ph * pw


def pooled_feature_dim(vision_model: str, image_size) -> int:
    """The width of `build_pooled_vision_tower`'s features at
    `image_size`: the ResNet's channels, or the FPN's pooled p6."""
    if is_detectron2(vision_model):
        return full_img_feature_dim(image_size, True)
    return _SPECS[vision_model][2]
