"""Model construction in the port: Dense, Embed and Conv skip torch's
default init (their `reset_parameters` zeros them) because `init_weights`
or a checkpoint sets every one of them. Each model family is built at a
tiny size: every such layer is zero after construction and none of their
weights is left at zero by `init_weights`, which is the same for a seed as
it was under torch's default init (the global generator is not drawn)."""

import pytest
import torch

from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.berson import BersonOrdering
from multimodal_sequencing_tpu_torch.models.clip_visual import Conv
from multimodal_sequencing_tpu_torch.models.encoder import Dense, Embed
from multimodal_sequencing_tpu_torch.models.fpn import FPNVisionTower
from multimodal_sequencing_tpu_torch.models.pretrainer import (
    SequencingPretrainer)
from multimodal_sequencing_tpu_torch.models.pure_decode import (
    EncoderIndexDecoder)
from multimodal_sequencing_tpu_torch.models.sequencer import (
    SequencingModel, init_weights)

LAYERS = (Dense, Embed, Conv)


def _cfg(version="v1", **kw):
    return tcfg.MultimodalConfig(
        encoder=tcfg.EncoderConfig.tiny(type_vocab_size=5),
        hierarchical_version=version, max_story_length=5, max_seq_length=48,
        per_seq_max_length=12, **kw)


def _clip(name, vcfg):
    return SequencingModel(
        _cfg(multimodal=True, image_size=(vcfg.image_resolution,) * 2,
             clip_model_name=name), vcfg)


MODELS = {
    "text_v1": lambda: SequencingModel(_cfg()),
    "pointer_p1": lambda: SequencingModel(_cfg("p1")),
    "pure_decode": lambda: EncoderIndexDecoder(_cfg("decode")),
    "clip_rn50": lambda: _clip("RN50", tcfg.CLIPVisionConfig.tiny_rn(
        image_resolution=64)),
    "clip_vit": lambda: _clip("ViT-B/32", tcfg.CLIPVisionConfig.tiny_vit()),
    "berson": lambda: BersonOrdering(_cfg(wrapper_model_type="berson")),
    "pretrainer": lambda: SequencingPretrainer(_cfg()),
    "visualbert": lambda: SequencingModel(_cfg(
        multimodal=True, multimodal_model_type="visualbert",
        vision_model="resnet18", image_size=(32, 32), visual_feat_dim=16)),
    "fpn_tower": lambda: FPNVisionTower("resnet18", fpn_channels=16),
}


def _layers(model):
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, LAYERS)]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_layers_are_built_at_zero_and_init_weights_sets_each(kind):
    state = torch.random.get_rng_state()
    model = MODELS[kind]()
    # the default draws are gone: the global generator did not move
    assert torch.equal(torch.random.get_rng_state(), state)
    layers = _layers(model)
    assert layers
    for name, mod in layers:
        for p in mod.parameters(recurse=False):
            assert not p.any(), name
    again = init_weights(MODELS[kind](), 3).state_dict()
    init_weights(model, 3)
    for name, mod in layers:
        assert mod.weight.any(), name
    for key, val in model.state_dict().items():
        assert torch.equal(val, again[key]), key
