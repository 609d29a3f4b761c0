"""The system under test: the PyTorch/CUDA sequencer's objects, built as
its trainers build them, from the configuration file and the traffic; its
launch counters; its state as the check reads it."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .weights import kinds


def model_configs(cfg: Dict, traffic: Dict):
    """(MultimodalConfig, CLIPVisionConfig or None) as `trainers.train`
    and `trainers.eval` build them for this configuration."""
    from multimodal_sequencing_tpu_torch.models.config import (
        CLIPVisionConfig, EncoderConfig, MultimodalConfig)
    raw, seq = cfg["raw"], cfg["raw"]["sequencer"]
    enc = EncoderConfig(**cfg["encoder"], pad_token_id=raw["pad_token_id"],
                        dtype=seq["dtype"], gelu_impl=seq["gelu_impl"])
    vis = cfg.get("vision")
    mcfg = MultimodalConfig(
        encoder=enc, max_story_length=seq["max_story_length"],
        min_story_length=seq["max_story_length"],
        max_seq_length=seq["max_seq_length"],
        per_seq_max_length=seq["per_seq_max_length"], cls_id=0,
        pad_id=raw["pad_token_id"], mask_id=4,
        multimodal=vis is not None, multimodal_model_type="clip",
        clip_model_name="RN50",
        image_size=((vis or {}).get("image_resolution", 224),) * 2,
        hierarchical_version=seq["hierarchical_version"],
        heatmap_decode_method=seq["heatmap_decode_method"],
        device_decode=bool(traffic.get("device_decode", False)))
    vcfg = None
    if vis is not None:
        vcfg = CLIPVisionConfig.rn50(
            dtype=seq["dtype"], image_resolution=vis["image_resolution"],
            layers=tuple(vis["layers"]), width=vis["width"],
            heads=vis["heads"], output_dim=vis["output_dim"])
    return mcfg, vcfg


def build_model(cfg: Dict, traffic: Dict, weights: Dict[str, torch.Tensor],
                device, for_eval: bool = False):
    """The sequencer on `device` holding `weights` (its checkpoint layout);
    for the evaluator cast for inference and in eval mode, as
    `trainers.eval` loads a checkpoint."""
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, cast_for_inference)
    mcfg, vcfg = model_configs(cfg, traffic)
    with torch.device(device):
        model = SequencingModel(mcfg, vcfg)
    model.load_state_dict(weights, strict=True)
    if for_eval:
        model = cast_for_inference(model).eval()
    return model


def optimizer(model, traffic: Dict):
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    o = traffic["optimizer"]
    return AdamW(model, learning_rate=o["learning_rate"],
                 warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                 weight_decay=o.get("weight_decay", 0.0),
                 adam_epsilon=o.get("adam_epsilon", 1e-8),
                 max_grad_norm=o.get("max_grad_norm", 1.0))


def _examples(stories: List[List[str]], with_images: bool):
    from multimodal_sequencing_tpu_torch.data.examples import HeadExample
    return [HeadExample(guid=f"bench-{i}", text_seq=list(s),
                        img_path_seq=([f"{i}:{k}" for k in range(len(s))]
                                      if with_images else None))
            for i, s in enumerate(stories)]


def dataset(kind: str, cfg: Dict, stories, images: Optional[np.ndarray],
            seed: int):
    """The trainer's `PureClassDataset` (kind `train`) or the evaluator's
    `SortDataset` (kind `eval`) over the pool, as `dataset_kwargs` of
    the trainers builds it (uint8 images on the device tail); a step
    image is read from the pool's arrays by its key."""
    from multimodal_sequencing_tpu_torch.data import datasets as D
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    base = D.PureClassDataset if kind == "train" else D.SortDataset

    class PoolDataset(base):
        def _load_images(self, paths):
            size = self.image_size
            return np.stack([
                images[int(p.split(":")[0])][int(p.split(":")[1])]
                if p is not None else np.zeros((size[0], size[1], 3), np.uint8)
                for p in paths])

    seq = cfg["raw"]["sequencer"]
    vis = cfg.get("vision")
    return PoolDataset(
        _examples(stories, images is not None),
        SimpleWordTokenizer(cfg["vocab_size"]),
        max_length=seq["max_seq_length"],
        per_seq_max_length=seq["per_seq_max_length"],
        max_story_length=seq["max_story_length"], seed=seed,
        multimodal=images is not None,
        image_size=((vis or {}).get("image_resolution", 224),) * 2,
        uint8_images=True)


def evaluator(cfg: Dict, traffic: Dict, device):
    """`SortEvaluator` as `trainers.eval` builds it (micro-batch four
    eval batches), recording each batch's heat maps and orders."""
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.train.evaluation import SortEvaluator

    class Recording(SortEvaluator):
        """Keeps each batch's heat maps and the orders `decode` gave."""

        def decode(self, heatmaps):
            return SortEvaluator.decode_heatmap(self, heatmaps)

        def decode_heatmap(self, heatmaps):
            orders = self.decode(heatmaps)
            self.records.append((np.array(heatmaps, copy=True),
                                 [list(map(int, o)) for o in orders]))
            return orders

    mcfg, _ = model_configs(cfg, traffic)
    seq = cfg["raw"]["sequencer"]
    packer = StoryPacker(SimpleWordTokenizer(cfg["vocab_size"]),
                         seq["max_seq_length"], seq["per_seq_max_length"])
    ev = Recording(mcfg, packer, device, micro_batch=traffic["eval_batch"] * 4)
    ev.records = []
    return ev


def launch_counts() -> Dict[str, int]:
    """The hand-written kernels' launch counters."""
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.ops import gelu as gl
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    fns = {"flash_fwd": att.flash_attention,
           "flash_bwd_prep": att.flash_bwd_prep,
           "flash_bwd_main": att.flash_bwd_main,
           "flash_bwd_post": att.flash_bwd_post,
           "gelu_fwd": gl.gelu_logit_erf_fwd,
           "gelu_bwd": gl.gelu_logit_erf_bwd,
           "layer_norm_fwd": ln.layer_norm_fwd,
           "layer_norm_bwd": ln.layer_norm_bwd}
    return {k: int(getattr(f, "launches", 0)) for k, f in fns.items()}


def program_readings(model, opt, weights_start: Dict[str, torch.Tensor],
                     cfg: Dict) -> Dict:
    """The program's state as the check reads it: each parameter's change
    from `weights_start`, and the BatchNorm running statistics."""
    kd = kinds(cfg)
    sd = model.state_dict()
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(
            (sd[n].float() - weights_start[n]).double()))
            for n in kd if kd[n] != "buffer"}
        buffers = {n: float(torch.linalg.vector_norm(sd[n].double()))
                   for n in kd if kd[n] == "buffer"}
    return {"change": change, "buffers": buffers}


def optimizer_nu(opt) -> Dict[str, torch.Tensor]:
    return dict(zip(opt.names, opt.nu))
