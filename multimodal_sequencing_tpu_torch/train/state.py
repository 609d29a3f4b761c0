"""Optimizer: AdamW + linear warmup/decay + global-norm clipping + gradient
accumulation (counterpart of `train/state.py`).

`AdamW` follows, step for step,
`optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1=0.9,
b2=0.999, eps, weight_decay, mask=_decay_mask, mu_dtype=bfloat16))`, wrapped
in `optax.MultiSteps` for accumulation:
  * clipping scales by max_norm / |g| only when |g| >= max_norm (no epsilon);
  * the update uses this step's f32 first moment, (1 - b1) * g + b1 *
    stored moment, where the jitted JAX step rounds b1 to `mu_dtype`
    (0.8984375 for bf16); only the stored copy is rounded to `mu_dtype`;
    the second moment stays f32;
  * bias correction uses the incremented count;
  * no decay on biases and LayerNorm and BatchNorm scales (the JAX mask
    exempts every `bias` and `scale` leaf), decay on everything else
    (embeddings, conv kernels and the CLIP towers' raw parameters
    included), chosen by module type; a parameter without a gradient (a
    frozen vision tower) takes a zero gradient and still decays;
  * the learning rate is the optax join of 0 -> lr over max(1, warmup)
    steps and lr -> 0 over the rest, at the count of real updates, so the
    first update has learning rate 0;
  * with accumulation k the update sees the running mean of k gradients
    and the counts advance only on real updates.
Parameters and gradients stay f32 on the model's device; the updates run as
PyTorch `_foreach` ops without host syncs. On a parallelized model
(`parallel/sharding_rules.py`) every update is elementwise on the rank's own
tensors (a tensor-parallel slice, an FSDP2 shard), the clipping norm is the
whole gradient's, each element counted once over the ranks, and
`state_dict` / `load_state_dict` hold whole moments (collectives on every
rank).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..models.clip_visual import BatchNorm
from ..models.encoder import LayerNorm
from ..parallel.sharding_rules import local, parallel_of
from .steps import global_norm

# the moment decay rates, fixed as the JAX package's make_optimizer fixes them
B1, B2 = 0.9, 0.999


def _decay_flags(model: nn.Module):
    """(name, parameter, decays) in `model.parameters()` order: no decay on
    `bias` leaves and LayerNorm and BatchNorm scales (the Flax `bias` and
    `scale` leaves)."""
    out = []
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            decays = not (name == "bias"
                          or isinstance(mod, (LayerNorm, BatchNorm)))
            out.append((f"{mod_name}.{name}" if mod_name else name, p, decays))
    return out


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int):
    """get_linear_schedule_with_warmup as the optax join computes it, in
    f32: count -> learning rate."""
    f = np.float32
    warmup = max(1, warmup_steps)
    decay = max(1, total_steps - warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f(1) - f(count) / f(warmup)
            return float((f(0.0) - f(lr)) * frac + f(lr))
        c = min(max(count - warmup, 0), decay)
        frac = f(1) - f(c) / f(decay)
        return float(f(lr) * frac)

    return schedule


class AdamW:
    def __init__(self, model: nn.Module, learning_rate: float = 5e-6,
                 warmup_steps: int = 100, total_steps: int = 100000,
                 weight_decay: float = 0.0, adam_epsilon: float = 1e-8,
                 max_grad_norm: float = 1.0, grad_accum_steps: int = 1,
                 mu_dtype: torch.dtype = torch.bfloat16):
        flags = _decay_flags(model)
        self.names = [n for n, _, _ in flags]
        self.par = parallel_of(model)
        # the parameters (their .grad), and the tensors the updates write
        self.owners = [p for _, p, _ in flags]
        self.params = (self.owners if self.par is None
                       else [local(p) for p in self.owners])
        self.decay = [t for t, (_, _, d) in zip(self.params, flags) if d]
        self.replicas = (None if self.par is None else
                         [self.par.replicas(n) for n in self.names])
        self.schedule = linear_warmup_decay(learning_rate, warmup_steps,
                                            total_steps)
        self.weight_decay = weight_decay
        self.eps = adam_epsilon
        self.max_grad_norm = max_grad_norm
        self.k = max(1, grad_accum_steps)
        self.b1_mu = float(torch.tensor(B1, dtype=mu_dtype))
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)
        self.count = 0       # real updates (the adam and schedule count)
        self.mini_step = 0   # accumulated micro-steps since the last update

    def zero_grad(self) -> None:
        for p in self.owners:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        """Each parameter's gradient (this rank's tensor of it); zeros where
        the loss did not reach it (as JAX's gradient tree has them)."""
        return [local(p.grad) if p.grad is not None else torch.zeros_like(t)
                for p, t in zip(self.owners, self.params)]

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        return global_norm(grads, self.replicas)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Takes one micro-step's gradients; returns their global norm."""
        g_norm = self._norm(grads)
        if self.k == 1:
            self._update(grads, g_norm)
            return g_norm
        # MultiSteps: running mean acc + (g - acc) / (n + 1)
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        if self.mini_step == self.k - 1:
            self._update(self.acc, self._norm(self.acc))
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        else:
            self.mini_step += 1
        return g_norm

    def _update(self, grads: List[torch.Tensor], g_norm: torch.Tensor) -> None:
        factor = torch.where(g_norm < self.max_grad_norm,
                             torch.ones_like(g_norm),
                             self.max_grad_norm / g_norm)
        g = torch._foreach_mul(grads, factor)
        # optax multiplies the stored moment by b1 as a weakly typed scalar,
        # so under jit b1 is rounded to mu's dtype and the product (exact in
        # f32) joins (1 - b1) * g in f32
        mu = [torch.empty_like(p) for p in self.params]
        torch._foreach_copy_(mu, self.mu)
        torch._foreach_mul_(mu, self.b1_mu)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - B2)
        count = self.count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            by_param = dict(zip(map(id, self.params), upd))
            torch._foreach_add_([by_param[id(p)] for p in self.decay],
                                self.decay, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-self.schedule(self.count))
        torch._foreach_copy_(self.mu, mu)
        self.count = count

    def state_dict(self) -> Dict:
        """Counts and moments, the moments keyed by parameter name (whole
        tensors: on a parallelized model a collective on every rank)."""
        def whole(ts):
            if self.par is None:
                return dict(zip(self.names, ts))
            return {n: self.par.full(n, t) for n, t in zip(self.names, ts)}

        state = {"count": self.count, "mini_step": self.mini_step,
                 "mu": whole(self.mu), "nu": whole(self.nu)}
        if self.acc is not None:
            state["acc"] = whole(self.acc)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = state["count"], state["mini_step"]
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for name, t in zip(self.names, mine):
                full = state[key][name]
                if self.par is not None:
                    full = self.par.part(name, full.to(t.device))
                t.copy_(full)
