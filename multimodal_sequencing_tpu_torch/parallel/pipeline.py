"""GPipe pipeline parallelism for the text encoder stack (counterpart of
`parallel/pipeline.py`).

The encoder's N transformer layers split into `n_stages` contiguous stages
(`stack_layer_params`) laid out over a ring (`parallel/mesh.py::Ring`):
the model group's ranks, one stage a rank (`--pipeline_parallel_size`, so
pipeline and tensor parallelism exclude each other, as both take the model
dim), or every stage in one process (how one card runs it). The batch
streams through as `n_micro` microbatches on the classic GPipe schedule
(`gpipe_layers`): at tick t stage s works on microbatch t - s, for
n_micro + n_stages - 1 ticks, and hands its output to stage s + 1 with one
`ppermute` a tick. A stage skips its bubble ticks, whose outputs JAX
computes and masks out; that changes no number. The backward is autograd
through the schedule: each `ppermute`'s backward sends the gradient back
(the reverse permutation), and every rank runs them in one order because
each tick's handoff depends on the last (`mesh.tie`). The last stage's
outputs are replicated over the ring, forward an all-reduce and backward
the identity (JAX's `psum`). Remat applies per layer when the config asks
for it (`models/encoder.py::remat_layer`).

Dropout: a microbatch's rows draw what the unpipelined step draws for them.
Each layer draws from its own stream, keyed as the unpipelined stack keys
it (`models/encoder.py::DropoutRng.streams`), each microbatch from a fork
of the stream's start, and within a `row_window` its masks and keep bits
are those of the microbatch's global rows. So a pipelined step equals the
unpipelined one up to rounding (JAX instead re-keys each tick: a
deliberate difference).

Gradients (`_reduce_grads`): every rank holds every layer (JAX keeps the
state replicated at rest, or sharded over the data group by FSDP alone),
so the update is the whole model's. Only the owner stage produces its
layers' gradients and only stage 0 the embeddings', so those sum over the
ring's ranks; every rank computes the head on the same replicated output,
so its gradients are not summed there. The data group sums every
gradient (each rank's loss is its share of the global one). With
`--fsdp` the model is FSDP2's over the data group (`parallel/
sharding_rules.py::parallelize`): the step calls the pipelined loss
through the root unit, so each layer is gathered when it first runs and
its gradient reduce-scattered onto its shard.

`make_pipeline_train_step` (the sequencer: v0, v1-v3, p0/p1) and
`make_berson_pipeline_train_step` (BERSON's text trunk through
`BersonOrdering.forward`'s `trunk_out`) return steps with `train_step`'s
signature; they refuse what the JAX package refuses, with its errors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from ..models.encoder import DropoutRng, check_rng, remat_layer
from .mesh import (MODEL_AXIS, Ring, _ReduceOut, data_parallel, data_size,
                   ppermute, row_slice, row_window, tie)
from .sharding_rules import local, parallel_of

PIPE_AXIS = MODEL_AXIS  # pipeline stages live on the mesh `model` axis
PIPELINED_VERSIONS = ("v0", "v1", "v2", "v3", "p0", "p1")


def stack_layer_params(enc, num_layers: int, n_stages: int) -> List[List]:
    """The stages of `enc`'s `layer_{i}` (a module or a mapping): n_stages
    lists of num_layers / n_stages contiguous layers."""
    if num_layers % n_stages:
        raise ValueError(
            f"num_hidden_layers={num_layers} not divisible by "
            f"pipeline stages={n_stages}")
    lps = num_layers // n_stages
    get = enc.__getitem__ if isinstance(enc, Mapping) else \
        (lambda name: getattr(enc, name))
    layers = [get(f"layer_{i}") for i in range(num_layers)]
    return [layers[s * lps:(s + 1) * lps] for s in range(n_stages)]


def _windowed(layer, rows):
    def call(h, mask, r):
        with row_window(*rows):
            return layer(h, mask, r)
    return call


def gpipe_layers(ecfg, stages: List[List], x: torch.Tensor,
                 attention_mask: torch.Tensor, rng: Optional[DropoutRng],
                 n_stages: int, n_micro: int, ring: Ring) -> torch.Tensor:
    """Run the layer stack over `x` (this rank's rows (B, S, H)) through
    the pipeline on `ring`; `stages` from `stack_layer_params`;
    attention_mask (B, S); `rng` None in a deterministic forward. Returns
    (B, S, H), the same on every position of the ring. In a data-parallel
    step B is this rank's share of the global batch, whose size the JAX
    package's checks read."""
    b_loc = x.shape[0]
    n_data = data_size()
    b = b_loc * n_data
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    if mb % n_data:
        raise ValueError(
            f"microbatch size {mb} (= batch {b} / n_micro {n_micro}) must "
            f"divide over the {n_data}-way data axis — raise the batch or "
            f"lower --pipeline_microbatches")
    _check_ring(ring, n_stages)
    mbl = b_loc // n_micro
    lps = len(stages[0])
    xm = x.split(mbl)
    maskm = attention_mask.split(mbl)
    off, total = row_slice(b_loc)
    rngs = None if rng is None else rng.streams(n_stages * lps)
    remat = ecfg.remat and torch.is_grad_enabled()
    # across ranks every rank must run every ppermute's backward, in one
    # order: each tick's handoff requires a gradient and depends on the
    # last one's (in one process the handoff is a rotation of a list)
    across = ring.group is not None
    chain = across and torch.is_grad_enabled()

    def stage_apply(s, h, m):
        for j, layer in enumerate(stages[s]):
            r = None if rngs is None else rngs[s * lps + j].fork()
            call = _windowed(layer, (off + m * mbl, total))
            h = (remat_layer(call, h, maskm[m], r) if remat
                 else call(h, maskm[m], r))
        return h

    held = ring.positions
    recv: List[Optional[torch.Tensor]] = [None] * len(held)
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        ys = []
        for i, s in enumerate(held):
            m = t - s
            if 0 <= m < n_micro:
                y = stage_apply(s, xm[m] if s == 0 else recv[i], m)
                if s == n_stages - 1:
                    outs[m] = y
            else:  # a bubble tick: nothing to compute
                y = torch.zeros_like(xm[0])
            if chain:
                y = tie(y, recv[i])
                if not y.requires_grad:
                    y = y.detach().requires_grad_()
            ys.append(y)
        if t < n_ticks - 1:
            recv = ppermute(ys, ring)
    if not across:
        return torch.cat(outs)
    out = (torch.cat(outs) if ring.rank == n_stages - 1
           else torch.zeros_like(x))
    # replicate the last stage's outputs over the ring (JAX's psum)
    return _ReduceOut.apply(tie(out, *ys), ring.group)


def _check_ring(ring: Ring, n_stages: int) -> None:
    if ring.size != n_stages:
        raise ValueError(
            f"mesh {PIPE_AXIS} axis is {ring.size}, "
            f"pipeline stages {n_stages} — build the mesh with "
            f"n_model=pipeline_parallel_size")


def _check_state(model, what: str) -> None:
    from ..models.clip_visual import BatchNorm
    if any(isinstance(m, BatchNorm) for m in model.modules()):
        raise NotImplementedError(
            f"{what} does not thread mutable model_state collections: "
            f"['batch_stats']")


def make_pipeline_train_step(cfg, ring: Ring, n_stages: int, n_micro: int):
    """Pipelined analogue of `train/steps.py::train_step` for TEXT
    sequencers: embeddings -> `gpipe_layers` -> the v0 pooler and
    `ClassificationHead`, the `HeatmapHead` (v1-v3) or the `PointerHead`
    (p0/p1, given the order labels). Returns (step, forward): `step(model,
    optimizer, batch, step, seed)` as `train_step`'s; `forward(model,
    batch, rng, deterministic)` the outputs, for parity tests. The model is
    one process's, or `parallelize(..., pipeline=True)`'s (with `fsdp` it
    rests sharded over the data group)."""
    from ..models.heads import gather_step_cls
    from ..train.steps import compute_loss

    if cfg.multimodal:
        raise NotImplementedError(
            "pipeline parallelism covers the text encoder stack; "
            "multimodal towers train with dp/tp/fsdp")
    if set(cfg.hl_include_objectives or []):
        raise NotImplementedError(
            "hl_include_objectives aux heads are not wired into the "
            "pipelined step yet — drop --pipeline_parallel_size or the "
            "aux objectives")
    _check_ring(ring, n_stages)
    v = cfg.hierarchical_version
    if v not in PIPELINED_VERSIONS:
        raise NotImplementedError(f"pipelined step: head {v}")
    ecfg = cfg.encoder

    def forward(model, batch, rng, deterministic=False):
        ids = batch["input_ids"]
        attn = batch.get("attention_mask")
        if attn is None:
            attn = torch.ones_like(ids)
        rng = check_rng(deterministic, rng)
        enc = model.encoder
        x = enc.embeddings(ids, batch.get("token_type_ids"), rng)
        stages = stack_layer_params(enc, ecfg.num_hidden_layers, n_stages)
        seq = gpipe_layers(ecfg, stages, x, attn.to(torch.int32), rng,
                           n_stages, n_micro, ring)
        outputs = {"sequence_output": seq}
        if v == "v0":
            pooled = torch.tanh(enc.pooler(seq[:, 0]))
            outputs["logits"] = model.cls_head(pooled, rng).float()
            return outputs
        reprs, present = gather_step_cls(seq, ids, cfg.cls_id,
                                         cfg.max_story_length)
        outputs["step_reprs"], outputs["present"] = reprs, present
        if v in ("p0", "p1"):
            outputs["pointer_logits"] = model.pointer_head(
                reprs, present, batch["labels"]).float()
        else:
            outputs["heatmap"] = model.heatmap_head(reprs, present)
        return outputs

    def loss_fn(model, db, rng):
        return compute_loss(cfg, forward(model, db, rng), db)

    def step(model, optimizer, batch, step, seed):
        _check_state(model, "pipelined step")
        return _pipelined_step(model, optimizer, batch, step, seed, loss_fn,
                               "encoder")

    return step, forward


def make_berson_pipeline_train_step(cfg, ring: Ring, n_stages: int,
                                    n_micro: int):
    """Pipelined analogue of `train/steps.py::berson_train_step`: the
    BERSON wrapper's inner TEXT trunk (embeddings + the layer stack, 20
    packed pairs a story) runs through `gpipe_layers`, and the wrapper's
    hierarchical attention, inter-encoder and pointer take its output
    through `BersonOrdering.forward`'s `trunk_out`. Multimodal inner
    encoders fuse vision inside the trunk and raise NotImplementedError.
    Returns `step(model, optimizer, batch, step, seed)`."""
    if cfg.multimodal:
        raise NotImplementedError(
            "pipeline parallelism covers the BERSON text trunk; "
            "multimodal inner encoders train with dp/tp/fsdp")
    _check_ring(ring, n_stages)
    ecfg = cfg.encoder

    def loss_fn(model, db, rng):
        ids3 = db["input_ids"]                  # (B, P, L)
        b, p, _ = ids3.shape

        def flat(t):
            return t.reshape((b * p,) + t.shape[2:])

        enc = model.inner
        x = enc.embeddings(flat(ids3), flat(db["token_type_ids"]), rng)
        stages = stack_layer_params(enc, ecfg.num_hidden_layers, n_stages)
        lang = gpipe_layers(ecfg, stages, x,
                            flat(db["attention_mask"]).to(torch.int32), rng,
                            n_stages, n_micro, ring)
        out = model(db, deterministic=False, rng=rng, trunk_out=lang)
        return out["loss"], {}

    def step(model, optimizer, batch, step, seed):
        _check_state(model, "pipelined BERSON step")
        return _pipelined_step(model, optimizer, batch, step, seed, loss_fn,
                               "inner")

    return step


def _pipelined_step(model, optimizer, batch, step: int, seed: int,
                    loss_fn: Callable, trunk: str) -> Dict[str, torch.Tensor]:
    """One pipelined train step: the loss of `loss_fn(model, batch, rng)`,
    backward, the gradient reductions, the clipped AdamW update; the loss,
    the metrics and the gradient norm summed over the data group (the
    norm is global), as `train_step` returns them."""
    from ..train.steps import _summed, device_batch
    device = next(model.parameters()).device
    par = parallel_of(model)
    fsdp = par is not None and par.fsdp
    with data_parallel(None if par is None else par.layout):
        db = device_batch(batch, device)
        model.train()
        rng = DropoutRng(seed + 1, step, device)
        loss, metrics = (par.train_module(loss_fn, db, rng) if fsdp
                         else loss_fn(model, db, rng))
        optimizer.zero_grad()
        # FSDP2 averages the data ranks' gradients; their terms sum
        (loss * par.n_data if fsdp else loss).backward()
        if par is not None:
            _reduce_grads(model, par, trunk)
        grad_norm = optimizer.step(optimizer.grads())
        return _summed({**{k: m.detach() for k, m in metrics.items()},
                        "loss": loss.detach(), "grad_norm": grad_norm})


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum each of `tensors` over `group` in place, in one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def _reduce_grads(model, par, trunk: str) -> None:
    """The pipelined backward's gradients made the whole model's (module
    docstring): without FSDP every gradient summed over the data group
    (FSDP2 has reduce-scattered its units' and `finish_grads` takes the
    rest); then the trunk's summed over the ring's ranks, a stage this
    rank does not run taking a zero gradient."""
    lay = par.layout
    if par.fsdp:
        par.finish_grads()
    elif lay.n_data > 1:
        _all_reduce_flat([p.grad for p in model.parameters()
                          if p.grad is not None], lay.data_group)
    if lay.n_model > 1:
        prefixes = (f"{trunk}.embeddings.", f"{trunk}.layer_")
        grads = []
        for n, p in model.named_parameters():
            if n.startswith(prefixes):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(local(p.grad))
        _all_reduce_flat(grads, lay.model_group)
