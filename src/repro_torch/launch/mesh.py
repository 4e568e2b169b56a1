"""Device meshes over ``torch.distributed`` ranks, and the collectives the
distributed modules take over a mesh's named axes.

The port of ``repro.launch.mesh``. A mesh is a ``DeviceMesh`` with dims
named ("data", "model"), or ("pod", "data", "model"), over the ranks of
the process group, one card a rank (NCCL) or CPU ranks (gloo).
:func:`init_process_group` starts that group: under ``torchrun`` from
the environment it sets, each rank on the card of its local rank;
otherwise as a world of one from an in-process store, so the
single-process command line needs no launcher.

Collectives: :func:`all_reduce` (in place, no autograd) and
:func:`psum` / :func:`pmean`, which differentiate as the reference's
``psum`` / ``pmean`` under ``shard_map``: the gradient of a sum over
ranks is the sum of the ranks' gradients. Each rank's gradients are
therefore its share of the whole (``launch.steps``).
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models import model as model_lib

Axes = Union[None, str, Iterable[str]]


def init_process_group(device="cuda") -> None:
    """Start the default process group once: NCCL for card tensors and
    gloo for CPU tensors (gloo alone without a card). Raises for
    ``cuda`` when no card is present."""
    dev = model_lib.resolve_device(device)
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
    grid = torch.tensor(list(ranks)[: math.prod(shape)]).reshape(shape)
    return DeviceMesh(model_lib.resolve_device(device).type, grid,
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


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`op` over the ranks of `axes` (every mesh axis for ``"all"``), in
    place; returns `t`."""
    names = mesh.mesh_dim_names if axes == "all" else _names(axes)
    for a in names:
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


class _PSum(torch.autograd.Function):
    """Sum over a group; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``, differentiable."""
    for a in _names(axes):
        x = _PSum.apply(x, mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """``jax.lax.pmean(x, axes)``, differentiable."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)
