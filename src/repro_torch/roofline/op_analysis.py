"""Per-rank FLOPs, HBM bytes, collective bytes and peak live bytes of one
call of a step function, counted op by op under a ``TorchDispatchMode``.

The counterpart of ``repro.roofline.hlo_analysis``, which parses XLA's
post-SPMD HLO text. Eager PyTorch has no such text: :func:`analyze` runs
the function (on ``meta`` tensors in the dry run, so nothing is computed
or allocated) and counts every ATen and c10d operator it dispatches. The
result keeps the reference's ``OpStats`` fields.

Cost model (one rank; the step already computes only its own share):
  flops   — products (``mm``, ``addmm``, ``bmm``, ``baddbmm``; ``einsum``,
            ``matmul`` and ``linear`` reach the dispatcher as these):
            2 * prod(out) * prod(contracted dims).
  bytes   — operand + output bytes of every operator that launches a
            kernel: views, ``detach``, ``empty`` and other metadata-only
            operators count nothing, and neither do collectives. This
            departs from the reference's ``_BYTE_OPS`` filter, which
            leaves bare elementwise ops out because XLA fuses them into
            their neighbours: eager PyTorch fuses nothing, so every
            operator's traffic is real HBM traffic on the card. A tensor
            counts its logical bytes, or its storage's where that is
            smaller (an expanded operand).
  collective_bytes — per kind (``all-reduce``, ``all-gather``,
            ``reduce-scatter``, ``all-to-all``): the bytes
            of the operand this rank sends in, for the c10d operators
            that ``torch.distributed``'s calls and DTensor's
            redistributions dispatch.
  peak_bytes — the most bytes of storages created during the call that
            were alive at once (outputs included while they live): a
            storage counts from the operator that makes it (not a view,
            not an in-place write into an operand) until the last tensor
            on it is freed, as weakref finalizers report. What autograd
            saves for the backward keeps its tensors alive, so it counts.

There is no ``while`` trip-count correction to port: an eager loop runs,
and is counted, every iteration.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

#: Products and the operand positions of their two factors.
_PRODUCTS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
             aten.baddbmm: (1, 2)}
#: Operators that launch no kernel but are not marked as views.
_NO_KERNEL = frozenset((aten.empty, aten.empty_like, aten.empty_strided,
                        aten.new_empty, aten.new_empty_strided,
                        aten._unsafe_view, aten.lift_fresh, aten.set_,
                        aten.resize_, aten._local_scalar_dense))
#: c10d operators by name: (kind, position of the operand sent in).
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0), "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
}
_C10D = ("c10d", "_c10d_functional")


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_count: int = 0
    peak_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel moves for `t`: its logical size, or its storage's
    where smaller (an expanded tensor)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _aliases_only(func) -> bool:
    """Whether every output of `func` is a view of an operand."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def product_flops(func, args) -> float:
    """2 * prod(out) * prod(contracted) of a product in ``_PRODUCTS``."""
    i, j = _PRODUCTS[func.overloadpacket]
    a, b = args[i], args[j]
    out = list(a.shape[:-1]) + [b.shape[-1]]
    return 2.0 * math.prod(out) * a.shape[-1]


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._live: Dict[int, list] = {}      # storage -> [bytes, tensors]
        self._now = 0

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._now -= entry[0]
            del self._live[key]

    def _track(self, view: bool, inputs: list, outputs: list) -> None:
        operands = {id(t) for t in inputs}
        in_keys = {t.untyped_storage()._cdata for t in inputs}
        for t in outputs:
            if id(t) in operands:
                continue                      # in place: the operand itself
            key = t.untyped_storage()._cdata
            if key not in self._live:
                if view or key in in_keys:
                    continue                  # a view of untracked storage
                self._live[key] = [t.untyped_storage().nbytes(), 0]
                self._now += self._live[key][0]
                self.stats.peak_bytes = max(self.stats.peak_bytes, self._now)
            self._live[key][1] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        outputs = _tensors(out)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        st = self.stats
        view = func.is_view or _aliases_only(func)
        if ns in _C10D:
            if name in _COLLECTIVES:
                kind, pos = _COLLECTIVES[name]
                sent = sum(tensor_bytes(t) for t in _tensors(args[pos]))
                st.collective_bytes[kind] = (
                    st.collective_bytes.get(kind, 0.0) + sent)
        elif not (view or func.overloadpacket in _NO_KERNEL):
            st.bytes_accessed += sum(tensor_bytes(t)
                                     for t in inputs + outputs)
            if func.overloadpacket in _PRODUCTS:
                st.flops += product_flops(func, args)
                st.dot_count += 1
        self._track(view, inputs, outputs)
        return out


def analyze(fn, *args, **kwargs) -> Tuple[Any, OpStats]:
    """Calls ``fn(*args, **kwargs)`` once; returns its result and the
    counts of the operators it dispatched (see the module docstring)."""
    with _Counter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
