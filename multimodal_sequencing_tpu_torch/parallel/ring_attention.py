"""Ring attention: exact attention over a sequence split across the
positions of a ring (counterpart of `parallel/ring_attention.py`).

Each position keeps its S / R query rows; the K/V blocks and their key
mask rotate around the ring (`parallel/mesh.py::Ring.shift`), and each
rotation is one flash attention launch at the block shape, which returns
the block's context and logsumexp (`ops/attention.py::flash_attention`):
flash within a block, ring across blocks, as the JAX module's docstring
proposes. The blocks merge in f32 by their logsumexps,

    m = max_r lse_r,  w_r = exp(lse_r - m),  o = sum_r w_r o_r / sum_r w_r,

the global lse = m + log(sum_r w_r), cast once at the end. A block whose
keys are all masked has lse_r = -1e9 + log(S / R) (-1e9 in f32): weight 0
when the row has live keys elsewhere, and the same weight as every other
block (the row uniform over all keys) when it has none, as JAX's `-1e9` /
`-inf` online-softmax recurrence gives.

The backward (`_RingAttention.backward`) runs the existing backward
kernels against the global lse, with no new kernel. bf16 on the card: one
`flash_bwd_prep` on the final (o, dO, lse) of each position, one
`flash_bwd_main` a rotation on (q, k_r, v_r, mask_r), whose dq partials
add into the position's f32 accumulator (under its turn counters, which
each launch leaves at 0) and whose dk_r, dv_r add into f32 buffers that
travel with their blocks and come home after R rotations, then one
`flash_bwd_post`. The wrappers run any head width up to 128
(`ops/attention.py::with_kernel_width`): the accumulator is at the kernel
width, and each wrapper pads and cuts its own tensors. f32 on the card: the same with
`flash_attention_bwd_dq` and `flash_attention_bwd_dkv` after the delta
reduction. The CPU takes the plain versions block by block. A key the mask
drops gets p = 0 in the backward, so a row whose keys are all masked gets
zero gradient (the flash backward's convention). No dropout, as in JAX.

Each process passes the part of the sequence it holds and gets the same
part of the output back, as a `shard_map` body sees its blocks: the whole
(B, H, S, D) global view where one process holds every position (as the
JAX function takes it), its own (B, H, S / R, D) block where each rank of
the model group holds one. Across ranks no rank holds more than its block
of q, k, v and the output, and the only collectives are the rotations.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.attention import (attention_bwd_reference, attention_delta,
                             flash_attention, flash_attention_bwd_dkv,
                             flash_attention_bwd_dq, flash_bwd_main,
                             flash_bwd_post, flash_bwd_prep)
from .mesh import Ring


def _blocks(x: torch.Tensor, ring: Ring, dim: int) -> List[torch.Tensor]:
    """The held positions' blocks of `x` (the held sequence) along `dim`."""
    return list(x.chunk(len(ring.positions), dim))


def _merge(os_: List[torch.Tensor], lses: List[torch.Tensor], shape):
    """(o in f32, global lse (B*H, S_blk)) of one position's R blocks."""
    b, h, s, _ = shape
    lse = torch.stack(lses)                         # (R, B*H, S_blk)
    m = lse.max(0).values
    w = torch.exp(lse - m)
    total = w.sum(0)
    o = sum(wr.view(b, h, s, 1) * orr.float() for wr, orr in zip(w, os_))
    return o / total.view(b, h, s, 1), m + torch.log(total)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, ring):
        qs, ks, vs, ms = (_blocks(q, ring, 2), _blocks(k, ring, 2),
                          _blocks(v, ring, 2), _blocks(mask, ring, 1))
        parts = [([], []) for _ in qs]
        for r in range(ring.size):
            for i, qi in enumerate(qs):
                o_r, lse_r = flash_attention(qi, ks[i], vs[i], ms[i])
                parts[i][0].append(o_r)
                parts[i][1].append(lse_r)
            if r < ring.size - 1:
                ks, vs, ms = (ring.shift(ks), ring.shift(vs),
                              ring.shift(ms))
        outs, lses = [], []
        for qi, (os_, ls) in zip(qs, parts):
            o, lse = _merge(os_, ls, qi.shape)
            outs.append(o.to(q.dtype))
            lses.append(lse)
        ctx.ring = ring
        ctx.save_for_backward(q, k, v, mask, *outs, *lses)
        return torch.cat(outs, 2)

    @staticmethod
    def backward(ctx, do):
        ring = ctx.ring
        q, k, v, mask, *rest = ctx.saved_tensors
        n = len(ring.positions)
        outs, lses = rest[:n], rest[n:]
        qs, ks, vs, ms = (_blocks(q, ring, 2), _blocks(k, ring, 2),
                          _blocks(v, ring, 2), _blocks(mask, ring, 1))
        dos = [x.contiguous() for x in _blocks(do, ring, 2)]
        cuda = q.device.type == "cuda"
        bf16 = cuda and q.dtype == torch.bfloat16
        if bf16:
            prep = [flash_bwd_prep(o, d, lse)
                    for o, d, lse in zip(outs, dos, lses)]
        elif cuda:
            deltas = [attention_delta(o, d) for o, d in zip(outs, dos)]
        dqs = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for x in qs]
        dks = [torch.zeros_like(x) for x in dqs]
        dvs = [torch.zeros_like(x) for x in dqs]
        for r in range(ring.size):
            for i, qi in enumerate(qs):
                args = (qi, ks[i], vs[i], ms[i])
                if bf16:
                    delta, lse2, acc, turns = prep[i]
                    dk, dv = flash_bwd_main(*args, lse2, delta, acc, turns,
                                            dos[i])
                elif cuda:
                    dqs[i] += flash_attention_bwd_dq(*args, lses[i],
                                                     deltas[i], dos[i])
                    dk, dv = flash_attention_bwd_dkv(*args, lses[i],
                                                     deltas[i], dos[i])
                else:
                    dq, dk, dv = attention_bwd_reference(
                        *args, outs[i], lses[i], dos[i])
                    dqs[i] += dq.float()
                dks[i] += dk.float()
                dvs[i] += dv.float()
            # the blocks move on; their dk, dv with them, home after R
            if r < ring.size - 1:
                ks, vs, ms = (ring.shift(ks), ring.shift(vs),
                              ring.shift(ms))
            dks, dvs = ring.shift(dks), ring.shift(dvs)
        if bf16:
            dqs = [flash_bwd_post(acc, qi) for (_, _, acc, _), qi in
                   zip(prep, qs)]
        grads = [torch.cat([g.to(x.dtype) for g in gs], 2)
                 for gs, x in ((dqs, q), (dks, k), (dvs, v))]
        return (*grads, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *, ring: Ring
                   ) -> torch.Tensor:
    """Exact multi-head attention with the sequence split over `ring`'s
    positions. q, k, v: (B, H, S_held, D), the part of the sequence this
    process holds (module docstring): all of it in one process, its
    position's block across ranks; mask: (B, S_held) key keep-mask.
    Returns the output of the same rows. The sequence must divide by the
    ring size."""
    b, _, s, _ = q.shape
    held = len(ring.positions)
    if s % held:
        raise ValueError(f"seq {s * ring.size // held} not divisible by "
                         f"ring size {ring.size}")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.int32, device=q.device)
    return _RingAttention.apply(q, k, v, mask.to(torch.int32), ring)
