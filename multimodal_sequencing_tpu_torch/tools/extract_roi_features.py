"""Offline ROI regional-feature extraction -> `{img}_maskrcnn.npy` sidecars
(counterpart of `tools/extract_roi_features.py`).

Walk a dataset's story images, run the ResNet-FPN tower in regional mode
(`models/fpn.py::FPNVisionTower`: static top-K objectness proposals,
ROI-align, box head) and write one sidecar per image, with the regional
features, their scores and boxes, which the datasets load under
`--include_num_img_regional_features` (`data/images.py::
load_maskrcnn_sidecar`, the JAX package's reads them too). Weights are
drawn from `--seed`, or a torchvision ResNet file for the backbone
(`--resnet_torch_weights`), or a checkpoint of this package's tower
(`--tower_checkpoint`: a `torch.save` of its state dict). The tower runs
on the card unless `--device cpu` is given (in the Python API,
`device="cpu"`); without a card either raises.

Usage:
  python -m multimodal_sequencing_tpu_torch.tools.extract_roi_features \\
      --data_dir data/wikihow --data_name wikihow --split train \\
      --num_regional_features 10
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from .extract_img_features import (collect_story_image_paths,
                                   write_regional_sidecar)

logger = logging.getLogger(__name__)


def build_roi_extractor(num_regional_features: int,
                        backbone: str = "resnet50",
                        image_size=(256, 256), seed: int = 0,
                        tower_checkpoint: str = None,
                        resnet_torch_weights: str = None, device="cuda"):
    """The regional FPN tower in eval mode on `device` (the card unless
    "cpu" is asked for; without a card it raises): a callable of
    (B, 3, H, W) f32 normalized images -> (full, regional, scores,
    boxes)."""
    from .. import resolve_device
    from ..models.fpn import FPNVisionTower
    from ..models.resnet import convert_torchvision_resnet
    from ..models.sequencer import init_weights

    device = resolve_device(device)
    # torchvision weights put the stride in conv2; detectron2 and the
    # tower's own checkpoints use the Caffe-style default
    tower = init_weights(FPNVisionTower(
        backbone_name=backbone, num_regional_features=num_regional_features,
        stride_in_1x1=not resnet_torch_weights), seed)
    if resnet_torch_weights:
        sd = torch.load(resnet_torch_weights, map_location="cpu",
                        weights_only=True)
        tower.bottom_up.load_state_dict(convert_torchvision_resnet(
            sd.get("state_dict", sd), backbone))
    if tower_checkpoint:
        tower.load_state_dict(torch.load(tower_checkpoint, map_location="cpu",
                                         weights_only=True))
    return tower.to(device).eval()


def extract_roi_sidecars(image_paths, num_regional_features: int = 10,
                         backbone: str = "resnet50", image_size=(256, 256),
                         batch_size: int = 16, seed: int = 0,
                         tower_checkpoint: str = None,
                         resnet_torch_weights: str = None, device="cuda",
                         tower=None):
    """Write a `{img}_maskrcnn.npy` sidecar per image (the tower of
    `build_roi_extractor` on `device`, or `tower` on its own device);
    returns their count. Runs on the card unless `device="cpu"`; without a
    card it raises."""
    from .. import resolve_device
    from ..data.images import load_and_transform

    device = resolve_device(device)
    if tower is None:
        tower = build_roi_extractor(num_regional_features, backbone,
                                    image_size, seed, tower_checkpoint,
                                    resnet_torch_weights, device)
    dev = next(tower.parameters()).device
    paths = list(image_paths)
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        imgs = torch.from_numpy(np.stack([
            load_and_transform(p, image_size) for p in chunk])).to(dev)
        with torch.inference_mode():
            _, regional, scores, boxes = tower(imgs)
        regional, scores, boxes = (t.float().cpu().numpy()
                                   for t in (regional, scores, boxes))
        for i, p in enumerate(chunk):
            write_regional_sidecar(p, regional[i],
                                   extra={"scores": scores[i],
                                          "boxes": boxes[i]})
        if (start // batch_size) % 20 == 0:
            logger.info("extracted %d/%d", start + len(chunk), len(paths))
    return len(paths)


def main(argv=None):
    from .. import resolve_device
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--data_name", default="wikihow")
    parser.add_argument("--split", default="train")
    parser.add_argument("--version_text", default=None)
    parser.add_argument("--backbone", default="resnet50")
    parser.add_argument("--num_regional_features", type=int, default=10)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tower_checkpoint", default=None,
                        help="state dict of this package's FPNVisionTower")
    parser.add_argument("--resnet_torch_weights", default=None,
                        help="torchvision ResNet .pth for the backbone")
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    paths = collect_story_image_paths(args.data_dir, args.data_name,
                                      args.split, args.version_text)
    logger.info("found %d unique images", len(paths))
    n = extract_roi_sidecars(
        paths, args.num_regional_features, args.backbone,
        (args.image_size, args.image_size), args.batch_size, args.seed,
        args.tower_checkpoint, args.resnet_torch_weights,
        resolve_device(args.device))
    logger.info("wrote %d sidecars", n)
    return n


if __name__ == "__main__":
    main()
