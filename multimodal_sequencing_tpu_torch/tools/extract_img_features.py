"""Offline image feature extraction (counterpart of
`tools/extract_img_features.py`).

Walk a dataset's story images, run a vision backbone (ResNet pooled
features or the CLIP tower's CLS) and save a `{image_path: feature}` dict
as .npy, the feature-cache format the JAX package's tool writes.
`write_regional_sidecar` writes an `{img}_maskrcnn.npy` ROI sidecar from any
(R, C) feature array, the format both packages' `load_maskrcnn_sidecar`
read (`tools/extract_roi_features.py` writes them from the ResNet-FPN
tower). The backbone runs on the card unless `--device cpu` is given (in
the Python API, `device="cpu"`; without a card either raises), with
weights drawn from `--seed` (Flax's initializers, `models/sequencer.py::
init_weights`), or OpenAI CLIP weights for a CLIP tower.

Usage:
  python -m multimodal_sequencing_tpu_torch.tools.extract_img_features \\
      --data_dir data/wikihow --data_name wikihow --split train \\
      --vision_model resnet50 --out features.npy
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)


def build_feature_extractor(vision_model: str = "resnet50",
                            image_size=(224, 224), seed: int = 0,
                            clip_weights: str = None, device="cuda"):
    """The backbone of `vision_model` (a torchvision ResNet name, or a
    CLIP tower: `RN50` or a ViT name) in eval mode on `device` (the card
    unless "cpu" is asked for; without a card it raises): a callable of
    (B, 3, H, W) f32 normalized images -> (B, D) features."""
    from .. import resolve_device
    from ..models.clip_visual import CLIPVisualTower
    from ..models.config import CLIPVisionConfig
    from ..models.resnet import ResNetBackbone
    from ..models.sequencer import init_weights

    device = resolve_device(device)
    if vision_model.startswith("resnet"):
        model = init_weights(ResNetBackbone(vision_model), seed)
    else:
        vcfg = (CLIPVisionConfig.rn50() if vision_model.startswith("RN")
                else CLIPVisionConfig.vit_b32())
        model = init_weights(CLIPVisualTower(vcfg), seed)
        if clip_weights:
            from ..models.convert import (convert_clip_rn50, convert_clip_vit,
                                          filter_visual_state_dict,
                                          load_torch_state_dict)
            sd = filter_visual_state_dict(load_torch_state_dict(clip_weights))
            model.load_state_dict(convert_clip_rn50(sd, vcfg.layers)
                                  if vcfg.is_resnet else convert_clip_vit(sd))
    return model.to(device).eval()


def extract_features(image_paths, vision_model: str = "resnet50",
                     image_size=(224, 224), batch_size: int = 32,
                     clip_weights: str = None, device="cuda", seed: int = 0,
                     model=None):
    """{path: np.ndarray feature} over `image_paths`, in batches (the
    backbone of `build_feature_extractor` on `device`, or `model` on its
    own device). Runs on the card unless `device="cpu"`; without a card it
    raises."""
    from .. import resolve_device
    from ..data.images import load_and_transform
    from ..models.clip_visual import CLIPVisualTower

    device = resolve_device(device)
    if model is None:
        model = build_feature_extractor(vision_model, image_size, seed,
                                        clip_weights, device)
    dev = next(model.parameters()).device
    out = {}
    paths = list(image_paths)
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        imgs = torch.from_numpy(np.stack([
            load_and_transform(p, image_size) for p in chunk])).to(dev)
        with torch.inference_mode():
            feats = (model(imgs, img_len=1)
                     if isinstance(model, CLIPVisualTower) else model(imgs))
        for p, f in zip(chunk, feats.float().cpu().numpy()):
            out[p] = f
        if (start // batch_size) % 20 == 0:
            logger.info("extracted %d/%d", start + len(chunk), len(paths))
    return out


def collect_story_image_paths(data_dir: str, data_name: str, split: str,
                              version_text=None):
    """The sorted unique step-image paths of a split's stories."""
    from ..data.registry import get_processor
    proc = get_processor(f"{data_name}_sort", data_dir=data_dir,
                         version_text=version_text, paired_with_image=True)
    getter = {"train": proc.get_train_examples,
              "dev": proc.get_dev_examples,
              "val": proc.get_dev_examples,
              "test": proc.get_test_examples}[split]
    paths = []
    for ex in getter():
        for p in ex.img_path_seq or []:
            if p:
                paths.append(p)
    return sorted(set(paths))


def write_regional_sidecar(img_path: str, features: np.ndarray,
                           extra: dict = None):
    """Write `{img}_maskrcnn.npy` in the format `load_maskrcnn_sidecar`
    reads: a pickled dict whose `features` are (R, C) f32."""
    base, _ = os.path.splitext(img_path)
    payload = {"features": np.asarray(features, np.float32)}
    if extra:
        payload.update(extra)
    np.save(base + "_maskrcnn.npy", payload)  # saved as 0-d object array


def main(argv=None):
    from .. import resolve_device
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--data_name", default="wikihow")
    parser.add_argument("--split", default="train")
    parser.add_argument("--version_text", default=None)
    parser.add_argument("--vision_model", default="resnet50")
    parser.add_argument("--clip_visual_model_weights", default=None)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    paths = collect_story_image_paths(args.data_dir, args.data_name,
                                      args.split, args.version_text)
    logger.info("found %d unique images", len(paths))
    feats = extract_features(
        paths, args.vision_model, (args.image_size, args.image_size),
        args.batch_size, clip_weights=args.clip_visual_model_weights,
        device=resolve_device(args.device), seed=args.seed)
    np.save(args.out, feats)
    logger.info("saved %d features to %s", len(feats), args.out)
    return feats


if __name__ == "__main__":
    main()
