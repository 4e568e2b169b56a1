"""Carry weights between the reference and the port through numpy.

The two frameworks draw different numbers from the same seed, so parity
tests and the card's parity check hand both packages the same weights as
numpy arrays:

* :func:`numpy_params` draws a parameter tree with the reference's names
  and stacked ``(L, ...)`` layout from a numpy seed (float32; for the
  float32 configs the parity checks run).
* :func:`params_from_numpy` turns such a tree (or the reference's own
  parameters, as numpy arrays) into the port's, on a device, each leaf
  cast to the dtype the port keeps it in (the router float32, the rest
  the config's dtype).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

#: Leaves kept in float32 whatever the config's dtype.
FLOAT32_LEAVES = ("router",)


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
        leaf_dt = (torch.float32 if path.rsplit("/", 1)[-1]
                   in FLOAT32_LEAVES else dt)
        return _to_tensor(node, leaf_dt, dev)

    return conv(tree, want, "")


class _ShapeInit:
    """Shapes only: the tree of ``init_params`` without drawing it."""

    def dense(self, shape, in_axis_size=None, dtype=None):
        return tuple(shape)

    def embed(self, shape, dtype=None):
        return tuple(shape)

    def ones(self, shape, dtype=None):
        return tuple(shape)


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
