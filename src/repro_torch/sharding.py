"""Logical-axis sharding rules: params, activations, batches, caches.

The port of ``repro.sharding``, with the reference's rules leaf for leaf.
Scheme: mesh axes ("pod", "data", "model") — or ("data", "model")
single-pod.

* batch / DP: ("pod", "data") on the leading batch dim.
* FSDP: parameters shard their non-TP matrix dim over "data".
* TP: Megatron column/row parallel over "model" (heads / ffn / experts /
  SSM inner channels / vocab).
* Params are replicated across "pod".

Everything is keyed off parameter-tree paths (``repro_torch.tree``), so
models stay mesh-agnostic. A spec is a :class:`PartitionSpec` of the
port's own: one entry per tensor dim, each ``None``, an axis name or a
tuple of axis names. :func:`to_placements` turns specs into DTensor
placements on a ``DeviceMesh`` whose dims carry the axis names.

The reference's ``make_sharder`` (a ``with_sharding_constraint``
callback threaded through the models) has no counterpart: the port
computes each step on gathered tensors (``launch.steps``), so there is
no sharded activation for a constraint to act on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor

from repro_torch import tree as tree_lib

FSDP = "data"
TP = "model"
# Pure-FSDP (ZeRO-3) layout: both mesh axes act as one data-parallel /
# parameter-shard axis; no tensor parallelism. Chosen by layout="fsdp".
ZERO_AXES = ("data", "model")


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``PartitionSpec("model",
    None)`` splits dim 0 over "model" and keeps dim 1 whole; an entry may
    name several axes (``("data", "model")``), the first the major one.
    As jax's, an entry of one axis is that axis's name and an empty one
    is None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _canonical(entry):
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    return entry[0] if len(entry) == 1 else (entry or None)


P = PartitionSpec


def _spec_for_path(path: Tuple[str, ...], shape: Tuple[int, ...]) -> P:
    """PartitionSpec for a parameter, from its tree path (layer-stacked
    params get a leading None for the L axis)."""
    leaf = path[-1]
    stacked = "layers" in path

    def wrap(*spec):
        return P(*((None,) + spec if stacked else spec))

    if leaf == "embed":
        return P(TP, FSDP)
    if leaf == "lm_head":
        return P(FSDP, TP)
    if leaf in ("wq", "wk", "wv", "w1", "w3", "z_proj", "x_proj"):
        return wrap(FSDP, TP)
    if leaf in ("wo", "w2", "out_proj"):
        # MoE expert weights are 3D (E, ., .): expert-parallel over TP.
        if len(shape) - (1 if stacked else 0) == 3:
            return wrap(TP, None, FSDP) if leaf == "w2" else wrap(TP, FSDP, None)
        return wrap(TP, FSDP)
    if leaf == "router":
        return wrap(None, None)
    if leaf in ("bc_proj", "dt_proj"):
        return wrap(FSDP, None)
    if leaf in ("conv_x_w",):
        return wrap(None, TP)
    if leaf in ("conv_x_b", "norm"):       # (di,) SSM channel params
        return wrap(TP)
    if leaf in ("A_log", "D", "dt_bias"):  # (nh,)
        return wrap(TP)
    # norms, conv_bc_*, q_norm/k_norm, final_norm, scalars
    ndim = len(shape) - (1 if stacked else 0)
    return wrap(*([None] * ndim))


def param_specs(params_shape: Dict[str, Any], layout: str = "tp") -> dict:
    """Tree of PartitionSpec matching a params tree (tensors, or ``meta``
    tensors that only give shapes).

    layout="tp"   (default): Megatron TP over `model` x FSDP over `data`.
                  MoE w1/w3 (E, D, F): (TP, FSDP, None); w2: (TP, None, FSDP).
    layout="swep": as "tp", but the MoE experts only over TP (the
                  expert-parallel dispatch needs full D/F locally).
    layout="fsdp": pure ZeRO-3 — the largest divisible dim of every param
                  shards over BOTH axes; activations stay batch-sharded.
    """
    if layout == "fsdp":
        return _fsdp_specs(params_shape)

    def spec(path, leaf):
        stacked = "layers" in path
        base_ndim = len(leaf.shape) - (1 if stacked else 0)
        if path[-1] in ("w1", "w3") and base_ndim == 3:     # MoE experts
            s = (TP, None, None) if layout == "swep" else (TP, FSDP, None)
        elif path[-1] == "w2" and base_ndim == 3:
            s = (TP, None, None) if layout == "swep" else (TP, None, FSDP)
        else:
            return _spec_for_path(path, tuple(leaf.shape))
        return P(*((None,) + s if stacked else s))

    return tree_lib.unflatten((path, spec(path, leaf))
                              for path, leaf in tree_lib.flatten(params_shape))


def state_specs(params_shape: Dict[str, Any], layout: str = "tp") -> dict:
    """A train state's specs: params and AdamW moments by
    :func:`param_specs`, the step replicated."""
    pspec = param_specs(params_shape, layout)
    return {"params": pspec, "opt": {"m": pspec, "v": pspec, "step": P()}}


def _fsdp_specs(params_shape: Dict[str, Any], n_shards: int = 256) -> dict:
    """ZeRO-3: shard the first dim divisible by both axes (16*16=256) over
    ("data","model"); else first dim divisible by 16 over "data"; else
    replicate."""

    def spec(path, leaf):
        stacked = "layers" in path
        dims = list(leaf.shape[1:] if stacked else leaf.shape)
        out = [None] * len(dims)
        for i, d in enumerate(dims):
            if d % n_shards == 0:
                out[i] = ZERO_AXES
                break
        else:
            for i, d in enumerate(dims):
                if d % 16 == 0:
                    out[i] = FSDP
                    break
        return P(*((None,) + tuple(out) if stacked else tuple(out)))

    return tree_lib.unflatten((path, spec(path, leaf))
                              for path, leaf in tree_lib.flatten(params_shape))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Batch-sharding axes: as many of (pod, data) as divide the batch."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    while axes:
        n = 1
        for a in axes:
            n *= sizes[a]
        if global_batch % n == 0:
            return tuple(axes)
        axes.pop(0)   # drop pod first
    return None


def batch_specs(batch_struct: Dict[str, Any], dp) -> dict:
    """The batch over `dp` on its leading dim."""
    def spec(leaf):
        if leaf.dim() >= 1:
            return P(dp, *([None] * (leaf.dim() - 1)))
        return P()
    return tree_lib.map_leaves(spec, batch_struct)


def cache_specs(cache_struct: Dict[str, Any], dp) -> dict:
    """KV / SSM cache specs: batch over dp, heads/channels over TP."""

    def spec(path, leaf):
        key = path[-1]
        if key in ("k", "v"):                 # (L, B, Sc, nkv, hd)
            return P(None, dp, None, TP, None)
        if key in ("k_scale", "v_scale"):     # (L, B, Sc, nkv)
            return P(None, dp, None, TP)
        if key == "conv_x":                   # (L, B, K-1, di)
            return P(None, dp, None, TP)
        if key == "conv_bc":                  # (L, B, K-1, 2gn)
            return P(None, dp, None, None)
        if key == "h":                        # (L, B, nh, P, N)
            return P(None, dp, TP, None, None)
        ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        return P(*([None] * ndim))          # positions; index (a host int)

    return tree_lib.unflatten((path, spec(path, leaf))
                              for path, leaf in tree_lib.flatten(cache_struct))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(mesh, spec: P) -> tuple:
    """One spec as DTensor placements, one per mesh dim: ``Shard(i)`` on
    each mesh dim that dim ``i`` of the spec names, ``Replicate()``
    elsewhere. The axes of one entry must follow the mesh's order (the
    major one first), which is how DTensor nests two shards of one dim."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        dims = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {tuple(names)} does not have")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            dims.append(names.index(a))
            out[names.index(a)] = Shard(i)
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: the axes of dim {i} must follow "
                             f"the mesh's order {tuple(names)}")
    return tuple(out)


def to_placements(mesh, specs):
    """A tree of specs (or one spec) as a tree of placement tuples
    (the reference's ``to_named``)."""
    if isinstance(specs, PartitionSpec):
        return spec_placements(mesh, specs)
    return tree_lib.map_leaves(lambda s: spec_placements(mesh, s), specs)


# ---------------------------------------------------------------------------
# DTensors from full tensors and back
# ---------------------------------------------------------------------------


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """`t`, which every rank holds in full, as a DTensor with
    `placements`: each rank keeps its own shard (a copy; the full tensor
    can be freed), with no communication. On a mesh of one rank the
    DTensor wraps `t` itself."""
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements, run_check=False)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def distribute_tree(tree: Dict[str, Any], mesh, placements) -> dict:
    return tree_lib.map_leaves(lambda t, p: distribute(t, mesh, p), tree,
                               placements)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective over its mesh; on a
    mesh of one rank, its local tensor with no copy); any other tensor as
    it is."""
    if not isinstance(x, DTensor):
        return x
    if x.device_mesh.size() == 1:
        return x.to_local()
    return x.full_tensor()


def gather(x: DTensor, keep=()) -> torch.Tensor:
    """The local tensor of `x` with only the mesh axes in `keep` still
    sharding it: every other axis gathered. On a mesh of one rank, the
    local tensor itself."""
    mesh = x.device_mesh
    if mesh.size() == 1:
        return x.to_local()
    keep = set(_axes(keep))
    want = tuple(p if name in keep else Replicate()
                 for name, p in zip(mesh.mesh_dim_names, x.placements))
    if want == tuple(x.placements):
        return x.to_local()
    return x.redistribute(mesh, want).to_local()


def _coordinate(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(index, count) of this rank's block over `axes`, major first."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def local_block(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of `t` along `dim` over the mesh `axes` (major
    first), as DTensor cuts (``torch.chunk``); a view, `t` itself for no
    axes."""
    axes = _axes(axes)
    if not axes:
        return t
    idx, n = _coordinate(mesh, axes)
    return torch.chunk(t, n, dim=dim)[idx]


def shard_local(t: torch.Tensor, mesh, spec: P, done=()) -> DTensor:
    """`t` as a DTensor with `spec`'s placements, where `t` is already this
    rank's block over the axes in `done` (and whole along every other
    axis): it is cut along the axes of `spec` not in `done`, as DTensor
    cuts (``torch.chunk``). No communication."""
    done = set(_axes(done))
    local, shape = t, list(t.shape)
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        cut = tuple(a for a in axes if a in done)
        if cut:
            if cut != axes[:len(cut)]:
                raise ValueError(f"spec {spec}: the done axes must lead")
            shape[i] = t.shape[i] * _coordinate(mesh, cut)[1]
            axes = axes[len(cut):]
        local = local_block(local, mesh, axes, i)
    placements = spec_placements(mesh, spec)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
