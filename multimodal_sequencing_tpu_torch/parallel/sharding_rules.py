"""Which parameters shard over which mesh dim, and `parallelize`, which
shards a model by those rules (counterpart of `parallel/sharding_rules.py`).

The rules are the JAX package's path-suffix rules, matched against the
port's state-dict names, which mirror JAX's tree (`models/convert.py`):

  attention query/key/value weights and biases  -> split their output dim
  attention out weight                           -> split its input dim
  MLP intermediate weight and bias               -> split the output dim
  MLP output weight                              -> split the input dim
  everything else                                -> replicated

over the `model` dim, each only where that dimension divides. With
`fsdp`, a parameter of at least `_FSDP_MIN_ELEMS` elements also shards
its largest still-free dimension that divides over the `data` dim (JAX's
`_with_fsdp`); smaller ones stay replicated. `plan` computes both for a
model's full shapes; the set it shards equals JAX `tree_shardings`'s.

`parallelize(model, layout, sequence_parallel, fsdp)` applies the plan:

  * tensor parallelism: each `TransformerLayer` keeps its rank's slices of
    the split weights as plain parameters and gets the model group
    (`parallel/mesh.py::ModelGroup`), whose collectives its forward calls
    (`models/encoder.py`); every hand-written kernel sees local tensors;
  * `fsdp`: FSDP2 `fully_shard` over the data dim, one unit a
    `TransformerLayer` and one the rest, each planned parameter sharded on
    its planned dim (`shard_placement_fn`), the small ones left out
    (`ignored_params`) and their gradients all-reduced after the backward;
  * otherwise, with more than one rank, DDP over the data group
    (`find_unused_parameters`: the heads no step reaches keep no gradient,
    as in one process, and still decay in the optimizer).

The returned model is the one the optimizer, the checkpoints and the
evaluators use; `parallel_of(model)` gives its `Parallel` record, whose
`train_module` (the DDP wrapper, or the model) the train steps call.
FSDP2 keeps a shard of a planned dimension at rest, where XLA keeps its
own layout: what is held equal is the arithmetic.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import DATA_AXIS, Layout, ModelGroup, _chunk, _gather

# below this many elements FSDP keeps a parameter replicated
_FSDP_MIN_ELEMS = 1 << 16

# (state-dict name suffix, the dim of the port's tensor split over `model`)
_RULES = [
    (("attention", "query", "weight"), 0),
    (("attention", "key", "weight"), 0),
    (("attention", "value", "weight"), 0),
    (("attention", "query", "bias"), 0),
    (("attention", "key", "bias"), 0),
    (("attention", "value", "bias"), 0),
    (("attention", "out", "weight"), 1),
    (("intermediate", "weight"), 0),
    (("intermediate", "bias"), 0),
    (("output", "weight"), 1),
]


def tp_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The dim of parameter `name` split over the model dim, or None."""
    if n_model <= 1 or not shape:
        return None
    parts = tuple(name.split("."))
    for suffix, dim in _RULES:
        if parts[-len(suffix):] == suffix:
            return dim if shape[dim] % n_model == 0 else None
    return None


def fsdp_dim(shape, taken: Optional[int], n_data: int,
             min_elems: int = _FSDP_MIN_ELEMS) -> Optional[int]:
    """The largest dim other than `taken` that divides over n_data, for a
    parameter of at least `min_elems` elements (ties: the first)."""
    numel = 1
    for d in shape:
        numel *= d
    if not shape or numel < min_elems:
        return None
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if i != taken and d % n_data == 0 and d > best_size:
            best, best_size = i, d
    return best


def plan(named_shapes, n_data: int, n_model: int, fsdp: bool,
         fsdp_min_elems: int = _FSDP_MIN_ELEMS
         ) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """{name: (model dim, data dim)} of every parameter that shards."""
    out = {}
    for name, shape in named_shapes:
        shape = tuple(shape)
        t = tp_dim(name, shape, n_model)
        f = fsdp_dim(shape, t, n_data, fsdp_min_elems) if fsdp else None
        if t is not None or f is not None:
            out[name] = (t, f)
    return out


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's own tensor of a parameter or gradient (an FSDP2 DTensor's
    shard; a plain tensor as it is)."""
    return getattr(t, "_local_tensor", t)


@dataclass
class Parallel:
    """A parallelized model's layout and plan. `train_module` is what a
    train step calls; `ignored` the FSDP-replicated parameters whose
    gradients `finish_grads` all-reduces."""
    layout: Layout
    shards: Dict[str, Tuple[Optional[int], Optional[int]]]
    fsdp: bool
    train_module: nn.Module = None
    ignored: List[nn.Parameter] = field(default_factory=list)

    @property
    def n_data(self) -> int:
        return self.layout.n_data

    def replicas(self, name: str) -> int:
        """On how many ranks each element of parameter `name`'s local tensor
        lives."""
        t, f = self.shards.get(name, (None, None))
        return ((1 if t is not None else self.layout.n_model)
                * (1 if f is not None else self.layout.n_data))

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter (or moment) `name` from this rank's
        local one: gathered over the data dim, then the model dim (a
        collective on every rank)."""
        lay = self.layout
        t = local(t).detach()
        tdim, fdim = self.shards.get(name, (None, None))
        if fdim is not None and lay.n_data > 1:
            t = _gather(t, fdim, lay.data_group, lay.n_data)
        if tdim is not None:
            t = _gather(t, tdim, lay.model_group, lay.n_model)
        return t

    def part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's local tensor of parameter (or moment) `name`."""
        lay = self.layout
        tdim, fdim = self.shards.get(name, (None, None))
        if tdim is not None:
            full = _chunk(full, tdim, lay.model_rank, lay.n_model)
        if fdim is not None:
            full = _chunk(full, fdim, lay.data_rank, lay.n_data)
        return full

    def finish_grads(self) -> None:
        """After the backward: the FSDP-replicated parameters' gradients
        averaged over the data group (a parameter no step reached takes a
        zero gradient, as the optimizer would give it)."""
        if not self.ignored or self.layout.n_data == 1:
            return
        for p in self.ignored:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            dist.all_reduce(g, group=self.layout.data_group)
            p.grad = g.div_(self.layout.n_data)


def parallel_of(model: nn.Module) -> Optional[Parallel]:
    return getattr(model, "_parallel", None)


def parallelize(model: nn.Module, layout: Layout,
                sequence_parallel: bool = False, fsdp: bool = False,
                fsdp_min_elems: int = _FSDP_MIN_ELEMS) -> nn.Module:
    """Shard `model` (on its device, fully initialized) over `layout` by
    the plan (module docstring); returns it. A layout of one process leaves
    it as it is."""
    if not layout.distributed:
        return model
    from ..models.encoder import TransformerLayer
    shards = plan(((n, p.shape) for n, p in model.named_parameters()),
                  layout.n_data, layout.n_model, fsdp, fsdp_min_elems)
    if layout.n_model > 1:
        _split_layers(model, layout, shards, sequence_parallel)
    par = Parallel(layout, shards, fsdp)
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        params = dict(model.named_parameters())
        dims = {params[n]: f for n, (_, f) in shards.items()
                if f is not None}
        par.ignored = [p for p in params.values() if p not in dims]
        ignored = set(par.ignored)
        mesh = layout.mesh[DATA_AXIS]
        for m in model.modules():
            if isinstance(m, TransformerLayer):
                fully_shard(m, mesh=mesh, ignored_params=ignored,
                            shard_placement_fn=lambda p: Shard(dims[p]))
        fully_shard(model, mesh=mesh, ignored_params=ignored,
                    shard_placement_fn=lambda p: Shard(dims[p]))
        par.train_module = model
    else:
        from torch.nn.parallel import DistributedDataParallel
        dev = next(model.parameters()).device
        par.train_module = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=layout.data_group, broadcast_buffers=False,
            find_unused_parameters=True)
    object.__setattr__(model, "_parallel", par)
    return model


def _split_layers(model: nn.Module, layout: Layout, shards, sequence_parallel
                  ) -> None:
    """Keep this rank's slices of every TransformerLayer's split weights
    and give the layer its model group. A split parameter elsewhere, or a
    layer whose heads do not divide, raises ValueError."""
    from ..models.encoder import TransformerLayer
    group = ModelGroup(layout.model_group, layout.model_rank, layout.n_model,
                       sequence_parallel)
    done = set()
    for prefix, m in model.named_modules():
        if not isinstance(m, TransformerLayer):
            continue
        names = [n for n, _ in m.named_parameters()
                 if shards.get(f"{prefix}.{n}", (None,))[0] is not None]
        if not names:
            continue
        if (len(names) != len(_RULES)
                or m.cfg.num_attention_heads % layout.n_model):
            raise ValueError(
                f"{prefix}: tensor parallelism over {layout.n_model} ranks "
                f"needs whole heads and MLP columns on each rank")
        for n in names:
            owner, leaf = m.get_submodule(n.rsplit(".", 1)[0]), \
                n.rsplit(".", 1)[1]
            full = getattr(owner, leaf)
            part = _chunk(full.data, shards[f"{prefix}.{n}"][0],
                          layout.model_rank, layout.n_model)
            setattr(owner, leaf, nn.Parameter(part,
                                              requires_grad=full.requires_grad))
            done.add(f"{prefix}.{n}")
        m.tp = m.attention.tp = group
    left = {n for n, (t, _) in shards.items() if t is not None} - done
    if left:
        raise ValueError(f"tensor-parallel rules match parameters outside "
                         f"the encoder layers: {sorted(left)}")


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with whole tensors on the CPU (a collective on
    every rank of a parallelized model)."""
    par = parallel_of(model)
    out = {}
    for name, t in model.state_dict().items():
        out[name] = (par.full(name, t) if par is not None else t).detach().cpu()
    return out


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]
                         ) -> None:
    """Load a whole-tensor state dict (the single-process format) into
    `model`, taking this rank's part of each sharded parameter."""
    par = parallel_of(model)
    if par is None:
        model.load_state_dict(state)
        return
    own = model.state_dict()
    missing = set(own) - set(state)
    unexpected = set(state) - set(own)
    if missing or unexpected:
        raise RuntimeError(f"state dict mismatch: missing {sorted(missing)}, "
                           f"unexpected {sorted(unexpected)}")
    for name, t in own.items():
        local(t).copy_(par.part(name, state[name].to(local(t).device)))


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Within: an FSDP model's parameters are whole on every rank, so any
    of its methods (a beam search, an encode) runs; the evaluators run in
    it on every rank, as their forwards are collective."""
    par = parallel_of(model)
    if par is None or not par.fsdp:
        yield model
        return
    from torch.distributed.fsdp import FSDPModule
    units = [m for m in model.modules() if isinstance(m, FSDPModule)]
    for m in units:
        m.unshard()
    try:
        yield model
    finally:
        for m in units:
            m.reshard()
