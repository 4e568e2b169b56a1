"""Atomic, async checkpointing of nested dicts of tensors.

The port of ``repro.checkpoint.ckpt``; it writes the reference's files,
so a checkpoint written by either package restores in the other with
equal bytes. Layout: ``<dir>/step_<N:08d>/`` holding ``host_0.npz`` (the
full arrays: the port runs on one host) plus a ``manifest.json`` with the
keys, shapes and dtypes. Keys are the leaves' paths joined by ``/`` in
JAX's order (``params/layers/attn/wq``, ``opt/m/embed``, ``opt/step``).
Writes go to ``step_<N>.tmp`` and are renamed only after fsync — a crash
mid-save never corrupts the latest checkpoint (restore picks the newest
*complete* step directory).

bfloat16 has no numpy dtype without ``ml_dtypes``, and ``np.savez``
stores the reference's bfloat16 arrays as raw two-byte voids. The port
writes its bfloat16 tensors the same way (their bits as ``V2``; the
manifest says ``bfloat16``) and, on reading, reinterprets a void leaf as
the target's dtype rather than casting it.

``AsyncCheckpointer`` snapshots the tree to host memory synchronously
(cheap) and writes in a background thread, so training never blocks on
disk. ``restore`` fills a target tree of shapes and dtypes — tensors on
the ``meta`` device, which hold no memory — onto a device, and with a
mesh and placements lays each leaf out as a DTensor (each rank keeps its
shard).

A state of DTensors on a mesh of several ranks is saved as the
reference saves a sharded state on one host: the full arrays, gathered
on every rank (a collective: every rank calls ``save``) and written by
rank 0 alone.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch import tree as tree_lib

_BF16_BITS = np.dtype("V2")     # how np.savez stores a bfloat16 array


def _flatten(tree) -> Dict[str, Any]:
    return {"/".join(path): leaf for path, leaf in tree_lib.flatten(tree)}


def to_numpy(t) -> np.ndarray:
    """A leaf as the numpy array the reference would save (bfloat16 as
    its bits in a ``V2`` array), copied: the caller may go on updating
    the tensor in place."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = sharding.full_tensor(t.detach()).to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_BITS else str(a.dtype)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or a process
    with no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(path: str, step: int, tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final directory. With a
    process group, every rank calls it and rank 0 writes."""
    arrays = {k: to_numpy(v) for k, v in _flatten(tree).items()}
    final = os.path.join(path, f"step_{step:08d}")
    if not _writer():
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "host_0.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _apply_retention(path, keep)
    return final


def _apply_retention(path: str, keep: int) -> None:
    steps = sorted(all_steps(path))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)


def all_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(path, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def _to_tensor(leaf: np.ndarray, want: torch.dtype, device) -> torch.Tensor:
    if leaf.dtype.kind == "V":
        # npz stores bfloat16 as raw void bytes: reinterpret, don't cast.
        if leaf.dtype != _BF16_BITS or want != torch.bfloat16:
            raise ValueError(f"a {leaf.dtype} leaf cannot become {want}")
        bits = np.ascontiguousarray(leaf).view(np.int16)
        return torch.from_numpy(bits).view(want).to(device)
    return torch.from_numpy(np.array(leaf)).to(device=device, dtype=want)


def restore(path: str, target: Any, step: Optional[int] = None,
            device=None, mesh=None, placements=None) -> Any:
    """Restore into the structure of `target` (a tree of tensors, or of
    ``meta`` tensors that only give shapes and dtypes), each leaf cast to
    the target's dtype and put on `device` (default: the CPU); with
    `mesh`, as DTensors with the tree of `placements` (the reference's
    ``shardings``)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    device = torch.device("cpu") if device is None else torch.device(device)
    pairs = []
    with np.load(os.path.join(d, "host_0.npz")) as data:
        for tpath, want in tree_lib.flatten(target):
            key = "/".join(tpath)
            if key not in data:
                raise KeyError(f"checkpoint {d} missing key {key}")
            leaf = data[key]
            if tuple(leaf.shape) != tuple(want.shape):
                raise ValueError(f"checkpoint {d}: {key} has shape "
                                 f"{leaf.shape}, the target "
                                 f"{tuple(want.shape)}")
            pairs.append((tpath, _to_tensor(leaf, want.dtype, device)))
    tree = tree_lib.unflatten(pairs)
    if mesh is not None:
        tree = sharding.distribute_tree(tree, mesh, placements)
    return tree


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at-most-one in flight."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # Snapshot to host synchronously (device buffers mutate next step).
        host_tree = tree_lib.map_leaves(to_numpy, tree)
        if not _writer():
            return

        def _work():
            try:
                save(self.path, step, host_tree, keep=self.keep)
            except BaseException as e:   # noqa: BLE001 — surfaced in wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()
