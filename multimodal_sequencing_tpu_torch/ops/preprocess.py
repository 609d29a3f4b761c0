"""Image preprocessing on the model's device (counterpart of
`ops/preprocess.py`).

The loader ships uint8 (..., H, W, 3) images; the resize, scale and
normalize tail runs here, on the device of the images, in plain PyTorch
(the JAX package leaves it to XLA; no Pallas kernel is involved). Two
modes, as in the JAX package: `imagenet` ([0, 1] scale, bilinear resize,
ImageNet mean/std, RGB bytes) and `detectron2_bgr` (0-255 range, resize,
minus the Caffe pixel means in BGR order).

The resize is the JAX package's bilinear image resize, written out: a separable
triangle-kernel weight matrix per spatial axis (`_resize_weights`), widened
by the scale when it downsamples (JAX antialiases; `F.interpolate` does not
unless asked), normalized per output sample, and zero for samples outside
the input; the image is contracted with both matrices. It runs only when
the loader ships another size than the model's.

`images_to_nchw` is the conv towers' intake: (B, N, 3, H, W) float CHW
(host preprocessing) or (B, N, H, W, 3) uint8 -> (B * N, 3, H, W) float.
"""

from __future__ import annotations

from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# detectron2 Caffe-style: 0-255 BGR minus MODEL.PIXEL_MEAN (BGR order)
DETECTRON2_PIXEL_MEAN_BGR = (103.530, 116.280, 123.675)


def _resize_weights(in_size: int, out_size: int,
                    device) -> torch.Tensor:
    """(in_size, out_size) f32 weights of JAX's antialiased bilinear resize
    along one axis (its weight matrix with the triangle kernel and no
    translation)."""
    scale = torch.tensor(out_size / in_size, dtype=torch.float32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear_nhwc(x: torch.Tensor, size: Tuple[int, int]
                         ) -> torch.Tensor:
    """(N, H, W, C) f32 -> (N, h, w, C), as JAX's bilinear resize to (N, h,
    w, C)."""
    h, w = size
    wh = _resize_weights(x.shape[1], h, x.device)
    ww = _resize_weights(x.shape[2], w, x.device)
    return torch.einsum("nhwc,hy,wz->nyzc", x, wh, ww)


def preprocess_uint8_images(images_u8: torch.Tensor,
                            size: Tuple[int, int] = (224, 224),
                            to_chw: bool = True,
                            mode: str = "imagenet") -> torch.Tensor:
    """(..., H, W, 3) uint8 -> normalized f32, (..., 3, h, w) CHW by default
    or (..., h, w, 3) with `to_chw=False`."""
    lead = tuple(images_u8.shape[:-3])
    h, w = size
    x = images_u8.reshape((-1,) + tuple(images_u8.shape[-3:])).float()
    resize = tuple(images_u8.shape[-3:-1]) != (h, w)
    if mode == "detectron2_bgr":
        if resize:
            x = resize_bilinear_nhwc(x, (h, w))
        x = x - x.new_tensor(DETECTRON2_PIXEL_MEAN_BGR)
    elif mode == "imagenet":
        x = x / 255.0
        if resize:  # loaders ship pre-sized images
            x = resize_bilinear_nhwc(x, (h, w))
        x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
    else:
        raise ValueError(f"unknown preprocessing mode {mode!r}")
    if to_chw:
        return x.permute(0, 3, 1, 2).reshape(lead + (3, h, w))
    return x.reshape(lead + (h, w, 3))


def images_to_nchw(images: torch.Tensor, mode: str = "imagenet"
                   ) -> torch.Tensor:
    """The conv towers' intake: (B, N, 3, H, W) float CHW (already
    normalized by the host) or (B, N, H, W, 3) uint8 (normalized here, tail
    chosen by `mode`) -> (B * N, 3, H, W) float."""
    b, n = images.shape[:2]
    if images.dtype == torch.uint8:
        x = preprocess_uint8_images(images, size=tuple(images.shape[2:4]),
                                    to_chw=True, mode=mode)
        return x.reshape((b * n,) + tuple(x.shape[2:]))
    return images.reshape((b * n,) + tuple(images.shape[2:]))
