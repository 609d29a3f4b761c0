"""Process groups, the (data, model) mesh, the batch slice and the
collectives of a parallel step (counterpart of `parallel/mesh.py`).

A run is one process, or N ranks started by `torchrun` (NCCL, one card a
rank) or by the CLI's `--num_cpu_devices N` (gloo on the CPU).
`init_distributed` joins the process group from `torchrun`'s environment;
`make_mesh(n_data, n_model)` lays the ranks out as a
`torch.distributed.device_mesh` with dims ("data", "model") and returns
this rank's `Layout`.

What JAX's jit does from shardings is explicit here:

  * every rank loads the same global batch and draws the same host plans,
    then takes its rows (`batch_slice`);
  * a loss term is this rank's share of the global one: a mean divides by
    the count summed over the data group (`global_count`), so the terms of
    the ranks add up to the single-process loss and their gradients to its
    gradient;
  * a dropout mask or an attention keep bit is the one the single process
    draws for that element (`row_slice`; `ops/attention.py::global_bh`);
  * train-mode BatchNorm statistics are over the global batch
    (`data_all_reduce`, differentiable);
  * the tensor-parallel layers' collectives (`ModelGroup`) are Megatron's:
    identity forward / all-reduce backward into a column-split product,
    all-reduce (or, sequence-parallel, reduce-scatter) out of a row-split
    one, with the LayerNorm regions between them on S / model_size tokens.

The data-group context (`data_parallel`) is entered by the train steps
only: an eval runs the whole batch on every rank, so its means and
statistics are the single process's without a collective.

A ring (`Ring`) is the counterpart of a JAX mesh axis that a `shard_map`
body walks with `lax.ppermute`: `size` positions, held either by the
model group's ranks (one position a rank: `model_ring`) or all by this
process (`Ring(size)`, the counterpart of JAX's virtual devices, which is
how one card runs a pipeline or a ring attention). Code over a ring works
on the list of the positions this process holds (`Ring.positions`), one
value each; `ppermute` sends each position's value to position i + 1 and
receives position i - 1's, in one `batch_isend_irecv` across ranks, and
its backward runs the reverse permutation. `row_window` places a
microbatch's rows in the global batch, so its dropout masks and keep bits
are those the whole batch draws for them.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass
class Layout:
    """This rank's place in the (data, model) mesh; the defaults are one
    process. `mesh` is the DeviceMesh (None without a process group)."""
    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    mesh: object = None

    @property
    def data_group(self):
        return self.mesh.get_group(DATA_AXIS)

    @property
    def model_group(self):
        return self.mesh.get_group(MODEL_AXIS)

    @property
    def distributed(self) -> bool:
        return self.mesh is not None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank0() -> bool:
    """True on the rank that writes logs, checkpoints and results (and in a
    single process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group that `torchrun` (or `--num_cpu_devices`)
    describes in the environment (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`,
    `MASTER_PORT`): NCCL and `cuda:LOCAL_RANK` for a CUDA device, gloo for
    the CPU. Without that environment the run stays one process. Returns
    this rank's device."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cpu") -> Layout:
    """Lay the ranks out as a (data, model) mesh; n_data defaults to every
    rank over n_model. Raises ValueError (the JAX package's message) when
    the layout does not fit the ranks; unlike a JAX mesh it must use every
    rank."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(
            f"mesh (data={n_data}, model={n_model}) does not fit "
            f"{world} devices — run on a host with enough chips or "
            f"force a virtual CPU platform (--num_cpu_devices N)")
    if n_data * n_model != world:
        raise ValueError(
            f"mesh (data={n_data}, model={n_model}) leaves ranks of "
            f"{world} without a place")
    if not dist.is_initialized():
        return Layout()
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    data_rank, model_rank = mesh.get_coordinate()
    return Layout(n_data, n_model, data_rank, model_rank, mesh)


def batch_slice(batch: dict, layout: Optional[Layout]) -> dict:
    """This rank's rows of the global batch (the counterpart of
    `shard_batch`): every numeric array sliced on its leading axis into
    n_data equal parts; guids, texts and other entries pass through."""
    if layout is None or layout.n_data == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object and v.ndim:
            n = v.shape[0] // layout.n_data
            if n * layout.n_data != v.shape[0]:
                raise ValueError(f"batch entry {k} of {v.shape[0]} rows does "
                                 f"not split over {layout.n_data} ranks")
            v = v[layout.data_rank * n:(layout.data_rank + 1) * n]
        out[k] = v
    return out


# ----- the data group of a train step ---------------------------------------

_STEP: Optional[Layout] = None


@contextlib.contextmanager
def data_parallel(layout: Optional[Layout]):
    """Within: this rank trains on its slice of the global batch, so
    `global_count`, `row_slice`, `data_all_reduce` and `data_all_gather`
    work over the data group (each is the identity when `layout` has one
    data rank)."""
    global _STEP
    prev = _STEP
    _STEP = layout if layout is not None and layout.n_data > 1 else None
    try:
        yield
    finally:
        _STEP = prev


def step_layout() -> Optional[Layout]:
    return _STEP


def data_size() -> int:
    """The data ranks of the step (1 outside one)."""
    return 1 if _STEP is None else _STEP.n_data


def global_count(n: torch.Tensor) -> torch.Tensor:
    """A count (or any detached sum) summed over the data group of the
    step."""
    if _STEP is None:
        return n
    n = n.detach().clone()
    dist.all_reduce(n, group=_STEP.data_group)
    return n


def global_numel(x: torch.Tensor) -> int:
    """The element count of `x` over the data group (the slices are equal)."""
    return x.numel() * (1 if _STEP is None else _STEP.n_data)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the global batch: its sum over
    the global element count (`x.mean()` in one process)."""
    if _STEP is None:
        return x.mean()
    return x.sum() / global_numel(x)


_ROWS: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def row_window(offset: int, total: int):
    """Within: `row_slice` places the rows it is asked about at `offset` in
    a global batch of `total` rows (a pipeline microbatch of this rank's
    slice)."""
    global _ROWS
    prev = _ROWS
    _ROWS = (offset, total)
    try:
        yield
    finally:
        _ROWS = prev


def row_slice(rows: int) -> Tuple[int, int]:
    """(offset, global rows) of this rank's `rows` leading rows (inside a
    `row_window`, the window's)."""
    if _ROWS is not None:
        return _ROWS
    if _STEP is None:
        return 0, rows
    return _STEP.data_rank * rows, rows * _STEP.n_data


def _gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((size * xs.shape[0],) + xs.shape[1:])
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, size: int
                    ) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // size,) + xs.shape[1:])
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _chunk(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient of each input is the sum of the
    ranks' output gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward sums the ranks' gradients and
    keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.args = (group, rank, size)
        return _gather(x, 0, group, size)

    @staticmethod
    def backward(ctx, g):
        group, rank, size = ctx.args
        return _reduce_scatter(g, 0, group, size), None, None, None


def data_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data group of the step, differentiably."""
    if _STEP is None:
        return x
    return _AllReduce.apply(x, _STEP.data_group)


def data_all_gather(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of a per-row tensor, differentiably: a loss
    over them, taken on every rank, is then this rank's share of the
    global loss once divided by n_data."""
    if _STEP is None:
        return x
    return _GatherRows.apply(x, _STEP.data_group, _STEP.data_rank,
                             _STEP.n_data)


# ----- the model group of a tensor-parallel layer ---------------------------


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSeq(torch.autograd.Function):
    """Replicated -> this rank's sequence chunk; backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.args = (group, size)
        return _chunk(x, 1, rank, size)

    @staticmethod
    def backward(ctx, g):
        group, size = ctx.args
        return _gather(g, 1, group, size), None, None, None


class _GatherSeq(torch.autograd.Function):
    """Sequence chunks -> the whole sequence. `partial`: the consumer is a
    column-split product whose gradients are partial sums over the group
    (backward reduce-scatters); else a replicated consumer (backward keeps
    this rank's chunk)."""

    @staticmethod
    def forward(ctx, x, group, rank, size, partial):
        ctx.args = (group, rank, size, partial)
        return _gather(x, 1, group, size)

    @staticmethod
    def backward(ctx, g):
        group, rank, size, partial = ctx.args
        g = (_reduce_scatter(g, 1, group, size) if partial
             else _chunk(g, 1, rank, size))
        return g, None, None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """Partial sums -> this rank's sequence chunk of their sum; backward
    all-gathers."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.args = (group, size)
        return _reduce_scatter(x, 1, group, size)

    @staticmethod
    def backward(ctx, g):
        group, size = ctx.args
        return _gather(g, 1, group, size), None, None


@dataclass
class ModelGroup:
    """The tensor-parallel group of a layer (Megatron's conjugate
    collectives). `sequence_parallel`: the LayerNorm/dropout/residual
    regions run on S / size tokens where S divides (JAX's `seq_shard`
    rule; otherwise the layer runs as plain TP, as the constraint is a
    no-op there)."""
    group: object
    rank: int
    size: int
    sequence_parallel: bool = False

    def shards_sequence(self, s: int) -> bool:
        return self.sequence_parallel and self.size > 1 and s % self.size == 0

    def copy_in(self, x):
        """Into a column-split product: identity; backward all-reduce."""
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x):
        """Out of a row-split product: all-reduce; backward identity."""
        return _ReduceOut.apply(x, self.group)

    def scatter_seq(self, x):
        return _ScatterSeq.apply(x, self.group, self.rank, self.size)

    def gather_seq(self, x, partial: bool):
        return _GatherSeq.apply(x, self.group, self.rank, self.size, partial)

    def reduce_scatter_seq(self, x):
        return _ReduceScatterSeq.apply(x, self.group, self.size)


# ----- a ring of positions (the model axis of a shard_map) -------------------


@dataclass
class Ring:
    """`size` positions in a ring. `group` None: this process holds every
    position; else one position a rank of `group`, this rank's `rank`."""
    size: int
    group: object = None
    rank: int = 0

    @property
    def positions(self) -> List[int]:
        """The positions this process holds, in order."""
        return list(range(self.size)) if self.group is None else [self.rank]

    def shift(self, xs: List[torch.Tensor], step: int = 1
              ) -> List[torch.Tensor]:
        """Position i's value moved to position i + step (step +1 or -1) of
        each held position's value, no gradient: a rotation of the list in
        one process, one send and one receive across ranks."""
        if self.size == 1:
            return list(xs)
        if self.group is None:
            return xs[-step:] + xs[:-step]
        x = xs[0].contiguous()
        out = torch.empty_like(x)
        peer = dist.get_global_rank
        ops = [dist.P2POp(dist.isend, x,
                          peer(self.group, (self.rank + step) % self.size),
                          self.group),
               dist.P2POp(dist.irecv, out,
                          peer(self.group, (self.rank - step) % self.size),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [out]


def model_ring(layout: Layout) -> Ring:
    """The model group's ranks as a ring (one position a rank); one process
    is a ring of one."""
    if not layout.distributed or layout.n_model == 1:
        return Ring(layout.n_model)
    return Ring(layout.n_model, layout.model_group, layout.model_rank)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return tuple(ring.shift(list(xs), 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.ring.shift(list(gs), -1))


def ppermute(xs: List[torch.Tensor], ring: Ring) -> List[torch.Tensor]:
    """`lax.ppermute` over the ring with perm i -> i + 1: each held
    position's value goes to the next position, differentiably (the
    backward sends each gradient back to the position the value came
    from). `xs` holds one tensor for each of `ring.positions`, all of one
    shape; every rank of the ring must call it together."""
    return list(_PPermute.apply(ring, *xs))


class _Tie(torch.autograd.Function):
    """`x` unchanged, with `others` as inputs that receive zero gradients:
    a backward that reaches `x` then reaches them too."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.others])


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """`x`, whose backward also gives each of `others` a zero gradient (so
    a ring's ranks run the backward of every `ppermute` in one order)."""
    others = [o for o in others if o is not None and o.requires_grad]
    return _Tie.apply(x, *others) if others else x
