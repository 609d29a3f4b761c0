"""Image IO and the host preprocessing pipelines (copy of `data/images.py`,
without the random crop, which no ported path reads), and the
`{img}_maskrcnn.npy` regional-feature sidecars (`load_maskrcnn_sidecar`).

read -> grayscale to RGB -> strip alpha -> resize to (224, 224) -> [0, 1] ->
CHW -> ImageNet mean/std, or, for the device tail (`ops/preprocess.py`),
uint8 HWC resized on the host only; and the detectron2 Caffe-style BGR
variants. Decoding uses cv2 with a PIL fallback; a missing path, or a file
neither can read, gives zeros (the batches stay fixed-shape).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)

# detectron2 Caffe-style models consume 0-255 BGR minus MODEL.PIXEL_MEAN
# (BGR channel order)
DETECTRON2_PIXEL_MEAN_BGR = np.asarray([103.530, 116.280, 123.675],
                                       dtype=np.float32)

def read_image_rgb(filename: str) -> np.ndarray:
    """Read an image file as HWC RGB uint8 with the reference's fallbacks
    (grayscale->RGB, alpha strip; `img_utils.py:103-143`)."""
    img = None
    try:
        import cv2
        img = cv2.imread(filename, cv2.IMREAD_UNCHANGED)
        if img is not None:
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            elif img.shape[-1] == 4:
                img = img[:, :, :3][..., ::-1]  # BGRA -> RGB
            else:
                img = img[..., ::-1]  # BGR -> RGB
    except Exception:
        img = None
    if img is None:
        from PIL import Image, ImageFile
        ImageFile.LOAD_TRUNCATED_IMAGES = True
        with Image.open(filename) as im:
            img = np.asarray(im.convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] > 3:
        img = img[:, :, :3]
    return np.ascontiguousarray(img)


def rescale(img: np.ndarray, output_size) -> np.ndarray:
    """Resize to `output_size` ((H, W) tuple, or int = short side), returning
    float32 in [0,1] like skimage's `transform.resize`
    (`img_utils.py:27-56`)."""
    h, w = img.shape[:2]
    if isinstance(output_size, int):
        if h > w:
            new_h, new_w = int(output_size * h / w), output_size
        else:
            new_h, new_w = output_size, int(output_size * w / h)
    else:
        new_h, new_w = int(output_size[0]), int(output_size[1])
    try:
        import cv2
        out = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
    except Exception:
        from PIL import Image
        out = np.asarray(
            Image.fromarray(img.astype(np.uint8)).resize(
                (new_w, new_h), Image.BILINEAR))
    out = out.astype(np.float32)
    if out.max() > 1.5:  # came in as uint8 range
        out = out / 255.0
    return out


def normalize_chw(img01: np.ndarray) -> np.ndarray:
    """[0,1] HWC float -> ImageNet-normalized CHW float32
    (`processors.py:203-207`)."""
    out = (img01 - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(out.transpose(2, 0, 1)).astype(np.float32)


def load_and_transform(filename: Optional[str],
                       size: Tuple[int, int] = (224, 224),
                       normalize: bool = True) -> np.ndarray:
    """Full default pipeline; missing/None path yields zeros (the packed
    batches must stay fixed-shape)."""
    if filename is None:
        return np.zeros((3, size[0], size[1]), dtype=np.float32)
    try:
        img = read_image_rgb(filename)
    except Exception as e:
        logger.warning("Failed reading image %s (%s); using zeros",
                       filename, e)
        return np.zeros((3, size[0], size[1]), dtype=np.float32)
    img = rescale(img, size)
    if normalize:
        return normalize_chw(img)
    return np.ascontiguousarray(img.transpose(2, 0, 1)).astype(np.float32)


def load_image_stack(filenames: Sequence[Optional[str]],
                     size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Stack of per-step images, (N, 3, H, W) float32."""
    return np.stack([load_and_transform(f, size) for f in filenames])


def load_image_stack_uint8(filenames: Sequence[Optional[str]],
                           size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Stack of per-step images as (N, H, W, 3) uint8 (host decodes +
    integer-resizes only; scale/normalize/transpose run fused on device —
    `ops/preprocess.py`). 4x less H2D traffic than the float pipeline."""
    out = []
    for f in filenames:
        if f is None:
            out.append(np.zeros((size[0], size[1], 3), np.uint8))
            continue
        try:
            img = read_image_rgb(f)
        except Exception as e:
            logger.warning("Failed reading image %s (%s); using zeros", f, e)
            out.append(np.zeros((size[0], size[1], 3), np.uint8))
            continue
        try:
            import cv2
            r = cv2.resize(img, (size[1], size[0]),
                           interpolation=cv2.INTER_AREA)
        except Exception:
            from PIL import Image
            r = np.asarray(Image.fromarray(img).resize(
                (size[1], size[0]), Image.BILINEAR))
        out.append(r.astype(np.uint8))
    return np.stack(out)


def read_image_bgr(filename: str) -> np.ndarray:
    """Read an image as HWC **BGR** uint8 — the detectron2-path intake
    (the reference keeps cv2's native BGR order for this vision family,
    `img_utils.py:103-117`: gray -> BGR, no RGB conversion)."""
    img = read_image_rgb(filename)
    return np.ascontiguousarray(img[..., ::-1])


def _resize_linear_u8(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize with the default INTER_LINEAR interpolation — matching
    the reference's `Detectron2ImageTransform.__call__` exactly (NOT the
    INTER_AREA the imagenet pipeline uses)."""
    h, w = int(size[0]), int(size[1])
    try:
        import cv2
        return cv2.resize(img, (w, h))  # default: INTER_LINEAR
    except Exception:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((w, h),
                                                      Image.BILINEAR))


def load_image_stack_detectron2(filenames: Sequence[Optional[str]],
                                size: Tuple[int, int] = (256, 256),
                                pixel_mean=None) -> np.ndarray:
    """(N, 3, H, W) float32 stack in the reference's detectron2 Caffe
    pipeline: BGR read -> cv2.resize(size) INTER_LINEAR -> float32 0-255
    -> minus MODEL.PIXEL_MEAN (BGR order) -> CHW
    (`multimodal_utils.py:170-192`). Missing paths yield zeros-minus-mean
    (what the reference transform produces for a black image)."""
    mean = np.asarray(DETECTRON2_PIXEL_MEAN_BGR if pixel_mean is None
                      else pixel_mean, np.float32)
    out = []
    for f in filenames:
        if f is None:
            img = np.zeros((size[0], size[1], 3), np.float32)
        else:
            try:
                img = _resize_linear_u8(read_image_bgr(f),
                                        size).astype(np.float32)
            except Exception as e:  # noqa: BLE001 — log, keep shape
                logger.warning("Failed reading image %s (%s); using zeros",
                               f, e)
                img = np.zeros((size[0], size[1], 3), np.float32)
        img = img - mean
        out.append(np.ascontiguousarray(img.transpose(2, 0, 1)))
    return np.stack(out)


def load_image_stack_uint8_bgr(filenames: Sequence[Optional[str]],
                               size: Tuple[int, int] = (256, 256)
                               ) -> np.ndarray:
    """(N, H, W, 3) uint8 **BGR** stack for the detectron2 on-device tail
    (`ops/preprocess.py` mode='detectron2_bgr' subtracts the pixel means
    on device). Missing paths yield zeros (same post-mean value as the
    host float path)."""
    out = []
    for f in filenames:
        if f is None:
            out.append(np.zeros((size[0], size[1], 3), np.uint8))
            continue
        try:
            out.append(_resize_linear_u8(read_image_bgr(f), size))
        except Exception as e:  # noqa: BLE001 — log, keep shape
            logger.warning("Failed reading image %s (%s); using zeros", f, e)
            out.append(np.zeros((size[0], size[1], 3), np.uint8))
    return np.stack(out)


def load_maskrcnn_sidecar(img_path: str, num_features: int
                          ) -> Optional[np.ndarray]:
    """The first `num_features` rows of `{img}_maskrcnn.npy` beside an
    image (a pickled dict whose `features` are (R, C) regional features)
    as f32, or None when there is no sidecar."""
    import os
    path = os.path.splitext(img_path)[0] + "_maskrcnn.npy"
    if not os.path.exists(path):
        return None
    d = np.load(path, allow_pickle=True).item()
    return np.asarray(d["features"][:num_features], dtype=np.float32)
