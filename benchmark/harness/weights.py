"""The model configuration as the harness and the reference read it, and
the weights made from the seed on the card.

Every leaf is named as the program's checkpoints name it. The
distributions are those of Flax's default initializers: Dense and Conv
kernels `lecun_normal` (a normal truncated at two standard deviations,
variance 1 / fan_in, fan_in = kh * kw * cin for a conv), Embed tables
normal with std 1 / sqrt(features), zero biases, unit LayerNorm and
BatchNorm scales, running means 0 and variances 1, and the attention
pool's position table normal with std channels^-0.5. All truncated leaves
come from one uniform draw of a generator on the card (through the
inverse normal CDF), all normal leaves from one normal draw.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Tuple

import torch

# a standard normal truncated to [-2, 2] has this standard deviation
TRUNC_STD = 0.87962566103423978
PHI_MINUS_2 = 0.022750131948179195


def load_config(path: str) -> Dict:
    """The configuration file as the reference reads it."""
    with open(path) as f:
        raw = json.load(f)
    seq = raw["sequencer"]
    enc = {k: raw[k] for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size", "max_position_embeddings",
        "type_vocab_size", "layer_norm_eps", "hidden_dropout_prob",
        "attention_probs_dropout_prob")}
    cfg = {"name": raw["name"], "encoder": enc,
           "vocab_size": raw["vocab_size"],
           "dtype": seq["dtype"], "max_story_length": seq["max_story_length"],
           "max_seq_length": seq["max_seq_length"],
           "per_seq_max_length": seq["per_seq_max_length"],
           "decode_method": seq["heatmap_decode_method"],
           "gelu_impl": seq["gelu_impl"], "raw": raw, "vision": None}
    vis = raw.get("vision")
    if vis:
        cfg["vision"] = {k: vis[k] for k in ("layers", "width", "heads",
                                             "output_dim", "image_resolution")}
        cfg["vision"]["grid"] = vis["image_resolution"] // 32
    return cfg


def leaf_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, scale): kind `trunc` (scale = fan_in), `normal`
    (scale = std), `zeros`, `ones`, `norm_scale`, `buffer_zeros`,
    `buffer_ones`."""
    e = cfg["encoder"]
    hs, ff = e["hidden_size"], e["intermediate_size"]
    out = []

    def dense(name, fan_in, fan_out):
        out.append((name + ".weight", (fan_out, fan_in), "trunc", fan_in))
        out.append((name + ".bias", (fan_out,), "zeros", 0.0))

    def norm(name, n, buffers=False):
        out.append((name + ".weight", (n,), "norm_scale", 1.0))
        out.append((name + ".bias", (n,), "zeros", 0.0))
        if buffers:
            out.append((name + ".running_mean", (n,), "buffer_zeros", 0.0))
            out.append((name + ".running_var", (n,), "buffer_ones", 1.0))

    def embed(name, num, feat):
        out.append((name + ".weight", (num, feat), "normal", feat ** -0.5))

    embed("encoder.embeddings.word_embeddings", e["vocab_size"], hs)
    embed("encoder.embeddings.position_embeddings",
          e["max_position_embeddings"], hs)
    embed("encoder.embeddings.token_type_embeddings", e["type_vocab_size"], hs)
    norm("encoder.embeddings.ln", hs)
    v = cfg.get("vision")
    if v:
        pre = "encoder.visual_model.resnet"

        def conv(name, cin, cout, k):
            out.append((name + ".weight", (cout, cin, k, k), "trunc",
                        cin * k * k))

        w = v["width"]
        conv(pre + ".conv1", 3, w // 2, 3)
        norm(pre + ".bn1", w // 2, True)
        conv(pre + ".conv2", w // 2, w // 2, 3)
        norm(pre + ".bn2", w // 2, True)
        conv(pre + ".conv3", w // 2, w, 3)
        norm(pre + ".bn3", w, True)
        inplanes = w
        for stage, (blocks, mult, stride) in enumerate(
                zip(v["layers"], (1, 2, 4, 8), (1, 2, 2, 2))):
            for blk in range(blocks):
                name = f"{pre}.layer{stage + 1}_{blk}"
                planes = w * mult
                st = stride if blk == 0 else 1
                conv(name + ".conv1", inplanes, planes, 1)
                norm(name + ".bn1", planes, True)
                conv(name + ".conv2", planes, planes, 3)
                norm(name + ".bn2", planes, True)
                conv(name + ".conv3", planes, planes * 4, 1)
                norm(name + ".bn3", planes * 4, True)
                if st > 1 or inplanes != planes * 4:
                    conv(name + ".downsample_conv", inplanes, planes * 4, 1)
                    norm(name + ".downsample_bn", planes * 4, True)
                inplanes = planes * 4
        c = w * 32
        g = v["grid"]
        out.append((pre + ".attnpool.positional_embedding", (g * g + 1, c),
                    "normal", c ** -0.5))
        for p in ("q_proj", "k_proj", "v_proj"):
            dense(f"{pre}.attnpool.{p}", c, c)
        dense(pre + ".attnpool.c_proj", c, v["output_dim"])
        feat = 2 * v["output_dim"]
        dense("encoder.visn_fc.visn_fc", feat, hs)
        norm("encoder.visn_fc.visn_ln", hs)
        embed("encoder.visual_pos.x_position_embedding", g, feat)
        embed("encoder.visual_pos.y_position_embedding", g, feat)
        embed("encoder.visual_token_type.token_type_embedding",
              cfg["max_story_length"], feat)
    for i in range(e["num_hidden_layers"]):
        pre = f"encoder.layer_{i}"
        for p in ("query", "key", "value", "out"):
            dense(f"{pre}.attention.{p}", hs, hs)
        norm(pre + ".attention_ln", hs)
        dense(pre + ".intermediate", hs, ff)
        dense(pre + ".output", ff, hs)
        norm(pre + ".output_ln", hs)
    dense("encoder.pooler", hs, hs)
    dense("heatmap_head.parent_proj", hs, hs)
    dense("heatmap_head.child_proj", hs, hs)
    dense("heatmap_head.pair_mlp", 2 * hs, hs // 2)
    dense("heatmap_head.pair_out", hs // 2, 1)
    return out


def kinds(cfg: Dict) -> Dict[str, str]:
    """name -> `buffer`, `norm_scale` or `param`."""
    return {n: ("buffer" if k.startswith("buffer") else
                "norm_scale" if k == "norm_scale" else "param")
            for n, _, k, _ in leaf_specs(cfg)}


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf in f32 on `device`, from `seed`."""
    specs = leaf_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_trunc = sum(math.prod(s) for _, s, k, _ in specs if k == "trunc")
    n_norm = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    u = torch.empty(n_trunc, device=device).uniform_(
        PHI_MINUS_2, 1.0 - PHI_MINUS_2, generator=gen)
    trunc = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
    trunc.clamp_(-2.0, 2.0)
    normal = torch.empty(n_norm, device=device).normal_(generator=gen)
    out, at_t, at_n = {}, 0, 0
    for name, shape, kind, scale in specs:
        n = math.prod(shape)
        if kind == "trunc":
            std = math.sqrt(1.0 / scale) / TRUNC_STD
            out[name] = trunc[at_t:at_t + n].view(shape) * std
            at_t += n
        elif kind == "normal":
            out[name] = normal[at_n:at_n + n].view(shape) * scale
            at_n += n
        elif kind in ("zeros", "buffer_zeros"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out
