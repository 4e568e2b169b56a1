"""Carry weights between the reference and the port through numpy.

The two frameworks draw different numbers from the same seed, so parity
tests and the card's parity check hand both packages the same weights as
numpy arrays:

* :func:`numpy_params` draws a parameter tree with the reference's names
  and stacked ``(L, ...)`` layout from a numpy seed (float32; for the
  float32 configs the parity checks run).
* :func:`params_from_numpy` turns such a tree (or the reference's own
  parameters, as numpy arrays) into the port's, on a device, each leaf
  cast to the dtype the port keeps it in (the router and the SSM's
  ``A_log``, ``D`` and ``dt_bias`` float32, the rest the config's dtype).
* :func:`param_struct` gives that tree's shapes and dtypes as ``meta``
  tensors, which hold no memory (what a checkpoint is restored into).
* :func:`opt_from_numpy` and :func:`opt_to_numpy` carry AdamW's state,
  the reference's ``{"m", "v", "step"}``, into the port and back out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

#: Leaves kept in float32 whatever the config's dtype.
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")


class NumpyInit:
    """The draws of :class:`repro_torch.models.common.Init`, from a numpy
    Generator: float32 arrays, standard normal truncated to [-2, 2] (by
    redrawing what falls outside) times the same scales."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def _trunc_normal(self, shape: Sequence[int]) -> np.ndarray:
        x = self.rng.standard_normal(tuple(shape))
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = self.rng.standard_normal(int(bad.sum()))
            bad = np.abs(x) > 2.0
        return x

    def dense(self, shape, in_axis_size: int, dtype=None) -> np.ndarray:
        std = (1.0 / max(in_axis_size, 1)) ** 0.5
        return (self._trunc_normal(shape) * std).astype(np.float32)

    def embed(self, shape, dtype=None) -> np.ndarray:
        return (self._trunc_normal(shape) * 0.02).astype(np.float32)

    def ones(self, shape, dtype=None) -> np.ndarray:
        return np.ones(tuple(shape), dtype=np.float32)

    def zeros(self, shape, dtype=None) -> np.ndarray:
        return np.zeros(tuple(shape), dtype=np.float32)

    def const(self, values, dtype=None) -> np.ndarray:
        return np.asarray(values, dtype=np.float32)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def numpy_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """A float32 numpy parameter tree for `cfg`, in the reference's layout
    (``embed``, stacked ``layers``, ``final_norm``, ``lm_head`` when not
    tied), drawn from ``numpy.random.default_rng(seed)``."""
    cfg.validate()
    init = NumpyInit(seed)
    params: Dict[str, Any] = {
        "embed": init.embed((cfg.vocab_padded, cfg.d_model))}
    params["layers"] = _stack([model_lib.init_layer(init, cfg)
                               for _ in range(cfg.n_layers)])
    params["final_norm"] = init.ones((cfg.d_model,))
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((cfg.d_model, cfg.vocab_padded),
                                       cfg.d_model)
    return params


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes, without importing it
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    """The port's parameters from a numpy tree in the reference's layout.

    Raises ValueError when a leaf's shape differs from what `cfg` needs.
    """
    dt = model_lib.param_dtype(cfg)
    dev = model_lib.resolve_device(device)
    want = _shapes(cfg)

    def conv(node, spec, path):
        if isinstance(node, dict):
            if not isinstance(spec, dict) or set(node) != set(spec):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(node)} differ from the "
                                 "config's")
            return {k: conv(v, spec[k], f"{path}/{k}")
                    for k, v in node.items()}
        if tuple(np.shape(node)) != spec:
            raise ValueError(f"{path}: shape {tuple(np.shape(node))}, "
                             f"expected {spec}")
        return _to_tensor(node, _leaf_dtype(path, dt), dev)

    return conv(tree, want, "")


def _leaf_dtype(path: str, dt: torch.dtype) -> torch.dtype:
    return torch.float32 if path.rsplit("/", 1)[-1] in FLOAT32_LEAVES else dt


def param_struct(cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree for `cfg` as ``meta`` tensors: the shapes
    and dtypes of ``model.init_params``, without memory."""
    dt = model_lib.param_dtype(cfg)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        return torch.empty(node, dtype=_leaf_dtype(path, dt), device="meta")

    return conv(_shapes(cfg), "")


def opt_from_numpy(opt: Dict[str, Any], cfg: ModelConfig,
                   device="cuda") -> Dict[str, Any]:
    """AdamW's state in the port from the reference's as numpy
    (``{"m": tree, "v": tree, "step": scalar}``): float32 moments and an
    int32 step on `device`. Raises ValueError on a shape that `cfg` does
    not have."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    dev = model_lib.resolve_device(device)
    return {"m": params_from_numpy(opt["m"], f32, dev),
            "v": params_from_numpy(opt["v"], f32, dev),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32, device=dev)}


def opt_to_numpy(opt: Dict[str, Any]) -> Dict[str, Any]:
    """The port's AdamW state as the reference holds it, in numpy:
    float32 moment trees and an int32 scalar step."""
    def arr(t):
        return t.detach().cpu().numpy()
    return {"m": tree_lib.map_leaves(arr, opt["m"]),
            "v": tree_lib.map_leaves(arr, opt["v"]),
            "step": np.asarray(int(opt["step"]), dtype=np.int32)}


class _ShapeInit:
    """Shapes only: the tree of ``init_params`` without drawing it."""

    def dense(self, shape, in_axis_size=None, dtype=None):
        return tuple(shape)

    def embed(self, shape, dtype=None):
        return tuple(shape)

    def ones(self, shape, dtype=None):
        return tuple(shape)

    def zeros(self, shape, dtype=None):
        return tuple(shape)

    def const(self, values, dtype=None):
        return tuple(np.shape(values))


def _shapes(cfg: ModelConfig) -> Dict[str, Any]:
    init = _ShapeInit()

    def stack(node):
        return ({k: stack(v) for k, v in node.items()}
                if isinstance(node, dict) else (cfg.n_layers,) + node)

    out: Dict[str, Any] = {
        "embed": (cfg.vocab_padded, cfg.d_model),
        "layers": stack(model_lib.init_layer(init, cfg)),
        "final_norm": (cfg.d_model,),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return out
