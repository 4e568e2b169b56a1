"""Elastic re-meshing: rebuild the mesh from the live ranks and reshard a
checkpointed state onto it.

The port of ``repro.runtime.elastic``. When a rank is evicted (failure
or straggler policy), the controller picks the largest supported mesh
that fits the surviving ranks, rebuilds the placements from the same
logical rules (``repro_torch.sharding``), and restores the latest
checkpoint onto the new mesh. Every rank of the process group calls
these functions (a mesh's process groups are made collectively); a rank
left out of the new mesh gets no state.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import sharding
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.launch import mesh as mesh_lib


def viable_mesh_shapes(n_devices: int,
                       model_parallel: int) -> List[Tuple[int, int]]:
    """(data, model) shapes usable with `n_devices`, largest first."""
    out = []
    for data in range(n_devices // model_parallel, 0, -1):
        if data * model_parallel <= n_devices:
            out.append((data, model_parallel))
    return out


def rebuild_mesh(ranks: Optional[Sequence[int]] = None,
                 model_parallel: int = 1, device="cuda") -> DeviceMesh:
    """Largest (data, model) mesh over the surviving `ranks` (default:
    every rank of the process group)."""
    mesh_lib.init_process_group(device)
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    shapes = viable_mesh_shapes(len(ranks), model_parallel)
    if not shapes:
        raise RuntimeError(
            f"cannot build a mesh with model_parallel={model_parallel} "
            f"from {len(ranks)} ranks")
    return mesh_lib.mesh_over(ranks, shapes[0], ("data", "model"), device)


def reshard_state(state: dict, mesh) -> Optional[dict]:
    """Reshard a train state (whole tensors, or DTensors on the old mesh)
    onto `mesh`; None on a rank outside it."""
    state = tree_lib.map_leaves(sharding.full_tensor, state)
    if not mesh_lib.member(mesh):
        return None
    return sharding.distribute_tree(state, mesh, sharding.to_placements(
        mesh, sharding.state_specs(state["params"])))


def recover(ckpt_dir: str, init_fn: Callable[[], Any], target: Any,
            model_parallel: int = 1, ranks: Optional[Sequence[int]] = None,
            device="cuda"):
    """Full elastic recovery: new mesh + checkpoint restore + reshard.
    `target` gives the state's structure (``launch.steps.state_struct``
    as ``meta`` tensors), as for ``fault.resume_or_init``.

    Returns (state, start_step, mesh); state is None on a rank outside
    the new mesh."""
    mesh = rebuild_mesh(ranks, model_parallel, device)
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return reshard_state(init_fn(), mesh), 0, mesh
    state = ckpt.restore(ckpt_dir, target, step=step, device=device)
    return reshard_state(state, mesh), step, mesh
