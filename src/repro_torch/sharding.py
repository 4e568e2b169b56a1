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

The reference's ``to_named`` is :func:`to_placements`. Its
``make_sharder`` is :func:`make_sharder`: the callback the models take
as ``sharder``, which carries the mesh, the data axes and the
tensor-parallel group into them. The models compute each rank's own
shard of every layer with it (Megatron's column- and row-parallel
products over "model", FSDP shards gathered one layer at a time), and
each named activation it is called on is checked to be its spec's local
block.
"""

from __future__ import annotations

import collections
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor

from repro_torch import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib

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


# ---------------------------------------------------------------------------
# The activation sharder: the mesh, data axes and TP group in the models
# ---------------------------------------------------------------------------

#: The global size each dim of a named activation has, by role: "rows"
#: (the global batch), "d_model" and "vocab" (from the parameters),
#: "experts" (routed, padded) and "capacity" (LW+'s, given by the call).
ROLES = {"hidden": ("rows", None, "d_model"),
         "logits": ("rows", None, "vocab"),
         "expert_in": ("experts", "capacity", "d_model")}


def _block_size(size: int, mesh, axes, coord: Dict[str, int]) -> int:
    """This rank's block of a dimension of `size` cut over `axes`, major
    first, as DTensor cuts (``torch.chunk``)."""
    for a in _axes(axes):
        n = axis_sizes(mesh)[a]
        chunk = -(-size // n)
        size = max(0, min(chunk, size - coord[a] * chunk))
    return size


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _LiveLayer:
    """One gathered layer: alive while any of its gathered tensors is."""

    def __init__(self, owner: "Sharder", n: int):
        self.owner, self.n = owner, n
        owner._live += 1
        owner.max_live_layers = max(owner.max_live_layers, owner._live)

    def release(self) -> None:
        self.n -= 1
        if self.n == 0:
            self.owner._live -= 1


class Sharder:
    """The callback :func:`make_sharder` returns (the models' ``sharder``).

    ``sharder(name, x)`` returns `x`, after checking that a named
    activation's local shape is its spec's local block (raises
    ValueError otherwise; ``checked`` counts the calls by name). Besides,
    it carries what the models need to compute a rank's own shard:

    * ``tp``, ``tp_rank``: the size of the tensor-parallel axis ("model",
      under the ``tp`` and ``swep`` layouts; none under ``fsdp``) and this
      rank's index on it; :meth:`copy`, :meth:`reduce`, :meth:`psum` and
      :meth:`amax` over it (``launch.mesh``'s collectives);
    * :meth:`gather` and :meth:`layer`: a parameter's (a layer's) local
      shards whole over every axis but the tensor-parallel one, by the
      placements :meth:`bind` read from the state's DTensors; the
      gradient goes back reduce-scattered. ``max_live_layers`` counts the
      most layers whose gathered weights were alive at once.

    The default sharder (no mesh) does none of it: every method returns
    its input, and the models compute the plain operations."""

    def __init__(self, mesh=None, dp=None, layout: str = "tp",
                 specs: Optional[Dict[str, PartitionSpec]] = None):
        self.mesh, self.dp, self.layout = mesh, dp, layout
        self.specs = specs or {}
        names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
        self.tp_axis = TP if layout != "fsdp" and TP in names else None
        self.tp = axis_sizes(mesh)[TP] if self.tp_axis else 1
        self.tp_rank = mesh.get_local_rank(TP) if self.tp > 1 else 0
        #: The axes a rank's loss is a share over: every axis but the
        #: tensor-parallel one, whose ranks hold one loss between them.
        self.sum_axes = tuple(a for a in names if a != self.tp_axis)
        self.sizes: Dict[str, int] = {}
        self.params: Dict[Tuple[str, ...], Tuple[tuple, tuple]] = {}
        self.checked: collections.Counter = collections.Counter()
        self.max_live_layers = 0
        self._live = 0

    # -- the reference's callback -------------------------------------

    def __call__(self, name: str, x: torch.Tensor, **sizes) -> torch.Tensor:
        spec = self.specs.get(name)
        if self.mesh is None or spec is None:
            return x
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        for i, (role, entry) in enumerate(zip(ROLES[name], spec)):
            size = sizes.get(role, self.sizes.get(role)) if role else None
            if size is None:
                continue
            want = _block_size(size, self.mesh, entry, coord)
            if x.shape[i] != want:
                raise ValueError(
                    f"sharder: {name} {tuple(x.shape)} on rank "
                    f"{self.mesh.get_rank()}: dim {i} ({role}, {size} "
                    f"over {entry}) should be {want} here (spec {spec})")
        self.checked[name] += 1
        return x

    def bind(self, params: Dict[str, Any], rows: Optional[int] = None
             ) -> "Sharder":
        """This sharder for a step on `params` (a tree of DTensors) and a
        global batch of `rows`: each leaf's placements and global shape,
        and the global sizes of the named activations' dims."""
        out = Sharder(self.mesh, self.dp, self.layout, self.specs)
        for path, p in tree_lib.flatten(params):
            out.params[path] = (tuple(p.placements), tuple(p.shape))
            if path == ("embed",):
                out.sizes.update(vocab=p.shape[0], d_model=p.shape[1])
            elif path[-1] == "w1" and "moe" in path and p.dim() == 4:
                out.sizes["experts"] = p.shape[1]
        if rows is not None:
            out.sizes["rows"] = rows
        return out

    # -- tensor parallelism over "model" ------------------------------

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "copy" (``launch.mesh.copy``) over the TP axis."""
        if self.tp == 1:
            return x
        return mesh_lib.copy(x, self.mesh, self.tp_axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "reduce" (``launch.mesh.reduce``) over the TP axis."""
        if self.tp == 1:
            return x
        return mesh_lib.reduce(x, self.mesh, self.tp_axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the TP axis; its gradient the ranks' sum."""
        if self.tp == 1:
            return x
        return mesh_lib.psum(x, self.mesh, self.tp_axis)

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over the TP axis (no gradient)."""
        if self.tp == 1:
            return x
        return mesh_lib.all_reduce(x.detach().clone(), self.mesh,
                                   self.tp_axis,
                                   torch.distributed.ReduceOp.MAX)

    def tp_first(self, size: int) -> int:
        """The first index of this rank's block of a dimension of `size`
        cut over the TP axis (as DTensor cuts)."""
        return self.tp_rank * -(-size // self.tp)

    def gather_tp(self, t: torch.Tensor, dim: int, size: int
                  ) -> torch.Tensor:
        """`t`, this rank's block along `dim` over the TP axis, whole (an
        all-gather; the gradient reduce-scattered back)."""
        if self.tp == 1:
            return t
        return mesh_lib.gather(t, self.mesh, self.tp_axis, dim, size)

    def scale_grad(self, x: torch.Tensor, scale: float) -> torch.Tensor:
        """`x` forward, its gradient times `scale` backward."""
        if scale == 1.0:
            return x
        return _ScaleGrad.apply(x, scale)

    # -- LW+'s capacity buffer over FSDP -------------------------------

    def capacity_split(self) -> bool:
        """Whether ``expert_in``'s capacity dim is cut over "data": a
        tensor-parallel layout with more than one "data" rank."""
        return (self.mesh is not None and self.layout != "fsdp"
                and axis_sizes(self.mesh).get(FSDP, 1) > 1)

    def scatter_capacity(self, buf: torch.Tensor) -> torch.Tensor:
        """(E_loc, C, D) buffers, each holding this rank's assignments at
        their global slots -> this rank's block of C of their sum: a
        reduce-scatter over "data" and a sum over the other data axes;
        where the rows are the same on every "data" rank (not data
        parallel), the block of this rank's own buffer."""
        dp = _axes(self.dp)
        if FSDP not in dp:
            return local_block(buf, self.mesh, FSDP, 1)
        buf = mesh_lib.scatter(buf, self.mesh, FSDP, 1)
        return mesh_lib.psum(buf, self.mesh, [a for a in dp if a != FSDP])

    def gather_capacity(self, out: torch.Tensor, cap: int) -> torch.Tensor:
        """The transpose of :meth:`scatter_capacity`'s cut: every block of
        C, all-gathered over "data"."""
        return mesh_lib.gather(out, self.mesh, FSDP, 1, cap)

    # -- FSDP: parameters gathered where they are used ----------------

    def _gathered(self, t: torch.Tensor, path, stacked: bool) -> torch.Tensor:
        info = self.params.get(path)
        if info is None:
            return t
        placements, shape = info
        dims: Dict[int, list] = {}
        for name, p in zip(self.mesh.mesh_dim_names, placements):
            if isinstance(p, Shard) and name != self.tp_axis:
                dims.setdefault(p.dim, []).append(name)
        for dim, axes in dims.items():
            t = mesh_lib.gather(t, self.mesh, axes, dim - stacked,
                                shape[dim])
        return t

    def gather(self, t: torch.Tensor, path: Tuple[str, ...]
               ) -> torch.Tensor:
        """The parameter at `path` (its local shard `t`) gathered over its
        FSDP axes: whole but for the TP axis."""
        if self.mesh is None:
            return t
        return self._gathered(t, path, False)

    def layer(self, lp: Dict[str, Any]) -> Dict[str, Any]:
        """One layer's parameters (views of the stacked local shards)
        gathered over their FSDP axes."""
        if self.mesh is None:
            return lp
        flat = tree_lib.flatten(lp)
        out = [(path, self._gathered(t, ("layers",) + path, True))
               for path, t in flat]
        made = [g for (_, t), (_, g) in zip(flat, out) if g is not t]
        if made:
            live = _LiveLayer(self, len(made))
            for g in made:
                weakref.finalize(g, live.release)
        return tree_lib.unflatten(out)


#: The default ``sharder`` of the models: no mesh, no checks.
NO_SHARDER = Sharder()


def make_sharder(mesh, dp, layout: str = "tp") -> Sharder:
    """Activation-sharding callback threaded through the models, with the
    reference's specs: ``hidden`` P(dp, None, None); ``logits`` P(dp,
    None, TP), or P(dp, None, None) under ``fsdp``; ``expert_in`` P(TP,
    FSDP, None) (experts over "model", LW+'s capacity over "data"), or
    unsharded under ``fsdp``. See :class:`Sharder`."""
    if layout == "fsdp":
        specs = {"hidden": P(dp, None, None), "logits": P(dp, None, None),
                 "expert_in": P(None, None, None)}
    else:
        specs = {"hidden": P(dp, None, None), "logits": P(dp, None, TP),
                 "expert_in": P(TP, FSDP, None)}
    return Sharder(mesh, dp, layout, specs)
