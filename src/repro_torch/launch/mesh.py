"""Device meshes over ``torch.distributed`` ranks, and the collectives the
distributed modules take over a mesh's named axes.

The port of ``repro.launch.mesh``. A mesh is a ``DeviceMesh`` with dims
named ("data", "model"), or ("pod", "data", "model"), over the ranks of
the process group, one card a rank (NCCL) or CPU ranks (gloo).
:func:`init_process_group` starts that group: under ``torchrun`` from
the environment it sets, each rank on the card of its local rank;
otherwise as a world of one from an in-process store, so the
single-process command line needs no launcher.

Collectives, each over the ranks of one or more named axes:

* :func:`all_reduce` (in place, no autograd) and :func:`psum` /
  :func:`pmean`, which differentiate as the reference's ``psum`` /
  ``pmean`` under ``shard_map``: the gradient of a sum over ranks is the
  sum of the ranks' gradients.
* Megatron's two tensor-parallel operators: :func:`copy` (the identity
  forward, an all-reduce of the gradient backward), where a tensor
  every rank holds enters a rank's own shard of a layer, and
  :func:`reduce` (an all-reduce forward, the identity backward), where
  the ranks' partial outputs leave it.
* FSDP's :func:`gather` (an all-gather forward, a reduce-scatter of the
  gradient backward) and its transpose :func:`scatter` (a reduce-scatter
  forward, an all-gather backward). Blocks are DTensor's cuts
  (``torch.chunk``), so a dimension need not divide the ranks.

Each collective these functions issue, forward or backward, is counted
by axis and kind (``"all_reduce"``, ``"all_gather"``,
``"reduce_scatter"``): :func:`collective_counts`, :func:`reset_counts`.
Over an axis of one rank every function returns its input untouched and
issues nothing, so a world of one computes the plain operations.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

Axes = Union[None, str, Iterable[str]]


def init_process_group(device="cuda") -> None:
    """Start the default process group once: NCCL for card tensors and
    gloo for CPU tensors (gloo alone without a card). Raises for
    ``cuda`` when no card is present."""
    from repro_torch.models.model import resolve_device
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    if dist.is_torchelastic_launched():
        if dev.type == "cuda":
            torch.cuda.set_device(dist.get_node_local_rank())
        dist.init_process_group(backend, init_method="env://")
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def mesh_over(ranks, shape: Tuple[int, ...], axes: Tuple[str, ...],
              device="cuda") -> DeviceMesh:
    """A mesh of `shape` over the first ranks of `ranks`, row-major.
    Every rank of the process group calls it (its groups are made
    collectively)."""
    from repro_torch.models.model import resolve_device
    grid = torch.tensor(list(ranks)[: math.prod(shape)]).reshape(shape)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks)."""
    init_process_group(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have "
            f"{dist.get_world_size()} (start {n} processes, e.g. with "
            f"torchrun)")
    return mesh_over(range(n), shape, axes, device)


def make_host_mesh(model_parallel: int = 1, device="cuda") -> DeviceMesh:
    """(world // model_parallel, model_parallel) mesh over the first ranks
    of the world (tests, examples, the training driver)."""
    init_process_group(device)
    n = dist.get_world_size()
    dp = n // model_parallel
    if dp == 0:
        raise RuntimeError(
            f"model_parallel={model_parallel} needs at least "
            f"{model_parallel} ranks; the world has {n} (start them with "
            f"torchrun --nproc-per-node {model_parallel})")
    return mesh_over(range(n), (dp, model_parallel), ("data", "model"),
                     device)


def member(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of `mesh`'s."""
    return mesh.get_coordinate() is not None


def _names(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: DeviceMesh, axes: Axes) -> int:
    """Ranks over `axes` (1 for none)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in _names(axes))


_COUNTS: collections.Counter = collections.Counter()
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def collective_counts() -> Dict[Tuple[str, str], int]:
    """Collectives issued through this module since the last
    :func:`reset_counts`: ``{(axis, kind): calls}``."""
    return dict(_COUNTS)


def reset_counts() -> None:
    _COUNTS.clear()


def _reduce_into(t: torch.Tensor, mesh: DeviceMesh, axis: str,
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    _COUNTS[(axis, "all_reduce")] += 1
    dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`op` over the ranks of `axes` (every mesh axis for ``"all"``), in
    place; returns `t`."""
    names = mesh.mesh_dim_names if axes == "all" else _names(axes)
    for a in names:
        if axis_size(mesh, a) > 1:
            _reduce_into(t, mesh, a, op)
    return t


def all_gather_stack(t: torch.Tensor, mesh: DeviceMesh, axis: str
                     ) -> torch.Tensor:
    """Every rank's `t` over `axis`, stacked in rank order (no
    autograd)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t[None]
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    _COUNTS[(axis, "all_gather")] += 1
    _ALL_GATHER(out, t[None].contiguous(), group=mesh.get_group(axis))
    return out


def _block(size: int, n: int, idx: int) -> int:
    """The length of block `idx` of `n` of a dimension of `size`, cut as
    ``torch.chunk`` cuts (blocks of ceil(size / n), the last ones
    shorter or empty)."""
    chunk = -(-size // n)
    return max(0, min(chunk, size - idx * chunk))


def _gather_dim(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int,
                size: int) -> torch.Tensor:
    """The ranks' blocks of `x` along `dim` over `axis`, concatenated to
    `size` (each padded to ceil(size / n) for the collective)."""
    n = axis_size(mesh, axis)
    chunk = -(-size // n)
    x = x.movedim(dim, 0)
    if x.shape[0] < chunk:
        x = torch.cat([x, x.new_zeros((chunk - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    out = torch.empty((n * chunk,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _COUNTS[(axis, "all_gather")] += 1
    _ALL_GATHER(out, x.contiguous(), group=mesh.get_group(axis))
    return out[:size].movedim(0, dim)


def _scatter_dim(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                 dim: int) -> torch.Tensor:
    """The sum over `axis` of `x`, of which this rank keeps its block
    along `dim`."""
    n = axis_size(mesh, axis)
    size = x.shape[dim]
    chunk = -(-size // n)
    x = x.movedim(dim, 0)
    if size < n * chunk:
        x = torch.cat([x, x.new_zeros((n * chunk - size,)
                                      + tuple(x.shape[1:]))])
    out = torch.empty((chunk,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _COUNTS[(axis, "reduce_scatter")] += 1
    _REDUCE_SCATTER(out, x.contiguous(), group=mesh.get_group(axis))
    mine = _block(size, n, mesh.get_local_rank(axis))
    return out[:mine].movedim(0, dim)


class _PSum(torch.autograd.Function):
    """Sum over an axis; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _reduce_into(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_into(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


class _Copy(torch.autograd.Function):
    """Megatron's "copy": the identity; its gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_into(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


class _Reduce(torch.autograd.Function):
    """Megatron's "reduce": the sum over the axis; its gradient as is."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce_into(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather along a dim; the gradient reduce-scattered back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, size):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_dim(x, mesh, axis, dim, size)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_dim(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None, None)


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along a dim; the gradient all-gathered back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return _scatter_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather_dim(g, ctx.mesh, ctx.axis, ctx.dim, ctx.size), None,
                None, None)


def _each(fn, x, mesh, axes):
    for a in _names(axes):
        if axis_size(mesh, a) > 1:
            x = fn.apply(x, mesh, a)
    return x


def psum(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``, differentiable."""
    return _each(_PSum, x, mesh, axes)


def pmean(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """``jax.lax.pmean(x, axes)``, differentiable."""
    n = axis_size(mesh, axes)
    return x if n == 1 else psum(x, mesh, axes) / n


def copy(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """Megatron's "copy" over `axes`: `x` itself forward, its gradient
    all-reduced backward (a tensor every rank holds entering the ranks'
    own shards of a computation)."""
    return _each(_Copy, x, mesh, axes)


def reduce(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """Megatron's "reduce" over `axes`: the ranks' partial sums summed
    forward, the gradient passed through backward."""
    return _each(_Reduce, x, mesh, axes)


def gather(x: torch.Tensor, mesh: DeviceMesh, axes: Axes, dim: int,
           size: int) -> torch.Tensor:
    """FSDP's gather: `x`, this rank's block along `dim` of a dimension of
    `size` cut over `axes` (the major one first, as DTensor nests
    shards), whole along `dim`; the gradient is reduce-scattered back to
    the block (summed over the ranks)."""
    names = _names(axes)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = [size]
    for a in names:
        sizes.append(_block(sizes[-1], axis_size(mesh, a), coord[a]))
    for a, whole in reversed(list(zip(names, sizes[:-1]))):
        if axis_size(mesh, a) > 1:
            x = _Gather.apply(x, mesh, a, dim, whole)
    return x


def scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int
            ) -> torch.Tensor:
    """The transpose of :func:`gather` over one axis: the sum of the
    ranks' `x`, of which this rank keeps its block along `dim`; the
    gradient is all-gathered back."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Scatter.apply(x, mesh, axis, dim)
