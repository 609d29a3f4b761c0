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
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Tuple

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


def row_slice(rows: int) -> Tuple[int, int]:
    """(offset, global rows) of this rank's `rows` leading rows."""
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
