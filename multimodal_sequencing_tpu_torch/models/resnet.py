"""Torchvision-style ResNet backbones (counterpart of `models/resnet.py`):
the generic vision towers of `--vision_model resnet18/34/50/101`, the final
FC removed (global-average-pooled features), and the bottom-up trunk of the
FPN tower (`models/fpn.py`).

Plain `torch.nn` (torchvision is not needed). Module and parameter names
follow the Flax tree (`conv1`, `bn1`, `layer2_0/conv1`, `layer2_0/
downsample_bn`, ...), so weights move between the packages by name
(`models/convert.py`). Tensors are NCHW (channels-last memory on the card)
where the JAX package is NHWC. The convs are `F.conv2d` (cuDNN on the
card); the BatchNorms are the Flax-form `clip_visual.BatchNorm` (momentum
0.9 on the old statistic, the biased batch variance), never
`nn.BatchNorm2d`. In training (`deterministic=False`) the BatchNorms
normalize by the batch and update their running averages, frozen tower or
not, as in the JAX package.

`convert_torchvision_resnet` maps a torchvision state dict onto these
names; `BottleneckBlock(stride_in_1x1=True)` strides the 1x1 conv1
(Caffe / detectron2 style) instead of the 3x3 conv2.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clip_visual import BatchNorm, Conv


class BasicBlock(nn.Module):
    EXPANSION = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, 1, dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, dtype)
        self.bn2 = BatchNorm(planes, dtype)
        if stride != 1 or inplanes != planes:
            self.downsample_conv = Conv(inplanes, planes, 1, stride, 0, dtype)
            self.downsample_bn = BatchNorm(planes, dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        out = F.relu(self.bn1(self.conv1(x), deterministic))
        out = self.bn2(self.conv2(out), deterministic)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x),
                                          deterministic)
        return F.relu(out + identity)


class BottleneckBlock(nn.Module):
    EXPANSION = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 stride_in_1x1: bool = False):
        super().__init__()
        out = planes * self.EXPANSION
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv(inplanes, planes, 1, s1, 0, dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, s2, 1, dtype)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = Conv(planes, out, 1, 1, 0, dtype)
        self.bn3 = BatchNorm(out, dtype)
        if stride != 1 or inplanes != out:
            self.downsample_conv = Conv(inplanes, out, 1, stride, 0, dtype)
            self.downsample_bn = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        out = F.relu(self.bn1(self.conv1(x), deterministic))
        out = F.relu(self.bn2(self.conv2(out), deterministic))
        out = self.bn3(self.conv3(out), deterministic)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x),
                                          deterministic)
        return F.relu(out + identity)


_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 512),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 512),
    "resnet50": (BottleneckBlock, (3, 4, 6, 3), 2048),
    "resnet101": (BottleneckBlock, (3, 4, 23, 3), 2048),
}


def resnet_feature_dim(name: str) -> int:
    return _SPECS[name][2]


class ResNetBackbone(nn.Module):
    """(B, 3, H, W) -> pooled (B, C) features, or with `return_stages` the
    {"c2".."c5"} stage outputs (strides 4/8/16/32, NCHW) the FPN builds
    on. Outputs are in the compute dtype."""

    def __init__(self, name: str = "resnet50",
                 dtype: torch.dtype = torch.float32,
                 stride_in_1x1: bool = False):
        super().__init__()
        if name not in _SPECS:
            raise ValueError(f"unknown ResNet {name!r} (one of "
                             f"{sorted(_SPECS)})")
        block_cls, layers, _ = _SPECS[name]
        self.compute_dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, 3, dtype)
        self.bn1 = BatchNorm(64, dtype)
        self.blocks = []
        inplanes = 64
        for stage, (blocks, planes, stride) in enumerate(zip(
                layers, (64, 128, 256, 512), (1, 2, 2, 2))):
            names = []
            for b in range(blocks):
                kw = ({"stride_in_1x1": stride_in_1x1}
                      if block_cls is BottleneckBlock else {})
                name_b = f"layer{stage + 1}_{b}"
                self.add_module(name_b, block_cls(
                    inplanes, planes, stride if b == 0 else 1, dtype, **kw))
                inplanes = planes * block_cls.EXPANSION
                names.append(name_b)
            self.blocks.append(names)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                pool: bool = True, return_stages: bool = False):
        x = x.to(self.compute_dtype)
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x), deterministic))
        x = F.max_pool2d(x, 3, 2, 1)  # Flax pads the window with -inf too
        stages = {}
        for stage, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x, deterministic)
            stages[f"c{stage + 2}"] = x
        if return_stages:
            return stages
        if pool:
            return x.mean((2, 3))
        return x


def convert_torchvision_resnet(state_dict: Dict, name: str = "resnet50"
                               ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict (`fc` dropped, `num_batches_tracked`
    ignored) -> `ResNetBackbone` state-dict entries, BatchNorm running
    statistics included."""
    sd = state_dict
    block_cls, layers, _ = _SPECS[name]
    out: Dict[str, torch.Tensor] = {}

    def t(key):
        return torch.as_tensor(np.asarray(sd[key], dtype=np.float32)).clone()

    def conv(dst, src):
        out[f"{dst}.weight"] = t(f"{src}.weight")

    def bn(dst, src):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = t(f"{src}.{leaf}")

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    n_convs = 2 if block_cls is BasicBlock else 3
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for c in range(1, n_convs + 1):
                conv(f"{dst}.conv{c}", f"{src}.conv{c}")
                bn(f"{dst}.bn{c}", f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                conv(f"{dst}.downsample_conv", f"{src}.downsample.0")
                bn(f"{dst}.downsample_bn", f"{src}.downsample.1")
    return out
