"""The sequencer's first train steps in plain PyTorch, float32: forward,
the heat-map BCE over valid step pairs (a mean over the whole batch's
pairs), backward, global-norm clipping at `max_grad_norm` and AdamW
(optax's: bias-corrected moments, the linear warmup-then-decay schedule
read at the count before the update, so the first update has learning
rate 0; no decay on biases and norm scales).

The batch runs in blocks of rows so that it fits beside nothing else on
the card: each block's BCE sum, over the batch's pair count, is backed up
alone, and the gradients add. Dropout masks are drawn for the whole batch
first and cut by rows; the keep bits of a block's heads are those of
their global (row, head) index. The CLIP tower runs on the whole batch at
once, since its batch statistics span it, and its output's gradient is
collected over the blocks before its own backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import model as M
from .data import heatmap_targets
from .rng import joint_draws, keep_bits, text_draws

B1, B2 = 0.9, 0.999


def lr_schedule(lr: float, warmup_steps: int, total_steps: int):
    f = np.float32
    warmup = max(1, warmup_steps)
    decay = max(1, total_steps - warmup)

    def at(count: int) -> float:
        if count < warmup:
            frac = f(1) - f(count) / f(warmup)
            return float((f(0) - f(lr)) * frac + f(lr))
        c = min(max(count - warmup, 0), decay)
        return float(f(lr) * (f(1) - f(c) / f(decay)))

    return at


def decays(name: str, kinds: Dict[str, str]) -> bool:
    return not (name.endswith(".bias") or kinds.get(name) == "norm_scale")


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], kinds: Dict[str, str],
                 opt: Dict):
        self.params = params
        self.names = list(params)
        self.decay = {n: decays(n, kinds) for n in self.names}
        self.lr = lr_schedule(opt["learning_rate"], opt["warmup_steps"],
                              opt["total_steps"])
        self.wd = opt.get("weight_decay", 0.0)
        self.eps = opt.get("adam_epsilon", 1e-8)
        self.max_norm = opt.get("max_grad_norm", 1.0)
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        factor = 1.0 if norm < self.max_norm else self.max_norm / norm.item()
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for n in self.names:
            g = grads[n] * factor
            self.mu[n].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + self.eps)
            if self.wd and self.decay[n]:
                upd = upd + self.wd * self.params[n]
            self.params[n].sub_(lr * upd)
        return float(norm)


def _to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in
            batch.items()}


def leaf_norms(ts: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()) * scale)
            for n, t in ts.items()}


def grad_norms_from_nu(nu: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of the clipped gradient that the first update took,
    from the second moment after it: nu = (1 - b2) g^2."""
    return {n: float(torch.sqrt(v.double().sum() / (1 - B2)))
            for n, v in nu.items()}


def train_steps(weights: Dict[str, torch.Tensor], kinds: Dict[str, str],
                cfg: Dict, batches: List[Dict[str, np.ndarray]], seed: int,
                opt: Dict, first_step: int = 0, block_rows: int = 16,
                quant=M._id, rows_used: Optional[int] = None) -> Dict:
    """Runs len(batches) steps from `weights` (f32 on the card, consumed).
    Returns the losses, each leaf's norm of the first step's clipped
    gradient, of its change over the steps, and the BatchNorm running
    statistics after them. `rows_used` gives each step the first rows of
    its batch alone (a planted fault: half of the batch left out, the mean
    taken over the rest)."""
    ecfg, vcfg = cfg["encoder"], cfg.get("vision")
    device = next(iter(weights.values())).device
    start = {n: w.clone() for n, w in weights.items() if kinds[n] != "buffer"}
    params = {n: w.requires_grad_() for n, w in weights.items()
              if kinds[n] != "buffer"}
    P = dict(weights)
    optim = AdamW(params, kinds, opt)
    p_h = ecfg["hidden_dropout_prob"]
    hs = ecfg["hidden_size"]
    cdtype = getattr(torch, cfg["dtype"])
    out = {"losses": []}
    for k, nb in enumerate(batches):
        step = first_step + k
        if rows_used is not None:
            nb = {key: v[:rows_used] for key, v in nb.items()}
        bt = _to(nb, device)
        b, s = bt["input_ids"].shape
        target = torch.from_numpy(heatmap_targets(nb["labels"])).to(device)
        _, present = M.step_cls(bt["input_ids"][:, :, None].float(),
                                bt["input_ids"], cfg["max_story_length"])
        count = (present[:, :, None] & present[:, None, :]).sum()
        vis = vis_leaf = None
        if vcfg is not None:
            n_img = nb["images"].shape[1]
            s_vis = n_img * vcfg["grid"] ** 2 + 1
            emb, vmask, layers = joint_draws(seed, step, device, b, s, s_vis,
                                             hs, ecfg["num_hidden_layers"],
                                             p_h, cdtype)
            feats = M.rn50_tower(P, bt["images"], vcfg, True, quant)
            vis = M.visual_tokens(P, feats, n_img, vcfg["grid"], ecfg, vmask,
                                  quant)
            vis_leaf = vis.detach().requires_grad_()
        else:
            emb, layers = text_draws(seed, step, device, b, s, hs,
                                     ecfg["num_hidden_layers"], p_h, cdtype)
        total = torch.zeros((), dtype=torch.float64, device=device)
        for r0 in range(0, b, block_rows):
            r1 = min(b, r0 + block_rows)
            sl = slice(r0, r1)

            def bits_fn(seed_i, bb, hh, ss, r0=r0):
                bh = ((torch.arange(bb, device=device) + r0)[:, None] * hh
                      + torch.arange(hh, device=device)[None]).reshape(-1)
                return keep_bits(seed_i, bh, ss,
                                 ecfg["attention_probs_dropout_prob"]).view(
                    bb, hh, ss, ss)

            masks = (emb[sl], [(sd, m1[sl], m2[sl]) for sd, m1, m2 in layers])
            rows_b = {k2: bt[k2][sl] for k2 in ("input_ids", "attention_mask",
                                                 "token_type_ids")}
            heat, pres = M.heatmaps(P, rows_b, cfg,
                                    None if vis_leaf is None else vis_leaf[sl],
                                    masks, bits_fn, quant)
            bsum, _ = M.bce_sum(heat, target[sl], pres)
            (bsum / count).backward()
            total += bsum.detach().double()
        if vis is not None:
            vis.backward(vis_leaf.grad)
        out["losses"].append(float(total / count))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        optim.step(grads)
        for p in params.values():
            p.grad = None
        if k == 0:
            out["grad"] = grad_norms_from_nu(optim.nu)
    with torch.no_grad():
        out["change"] = leaf_norms({n: params[n] - start[n] for n in params})
        out["buffers"] = leaf_norms({n: w for n, w in weights.items()
                                     if kinds[n] == "buffer"})
    return out
