"""Int8 gradient compression for cross-replica reduction.

The port of ``repro.optim.compression``: before the data-parallel
gradient reduction, per-tensor-scaled int8 quantization cuts the
all-reduce volume 4x (float32) at <1% relative error on typical gradient
distributions. The quantize -> all-reduce(int32) -> dequantize pattern
runs on each rank over the process group of one mesh axis. The float32
operations are the reference's, in its order (``torch.round`` rounds half
to even, as ``jnp.round`` does), so the results are its bits.

Error feedback (residual carry) is provided for accuracy-critical runs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q int8, scale f32)."""
    amax = torch.max(torch.abs(g.float()))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum_grads(grads: dict, mesh, axis: str = "data") -> dict:
    """Mean-reduce per-replica gradients over a mesh axis with int8 payload.

    Each rank passes its own replica's gradient tree (the reference's
    leading replica dim, which it shards over `axis`, is the ranks of
    `axis` here). Per leaf: quantize against a scale shared by a MAX
    all-reduce -> SUM all-reduce of the int32 payload -> dequantize / n.
    Returns the mean gradient, the same on every rank of `axis`.
    """
    n = mesh_lib.axis_size(mesh, axis)

    def reduce_leaf(g):
        _, scale = quantize(g)
        smax = mesh_lib.all_reduce(scale.clone(), mesh, axis,
                                   dist.ReduceOp.MAX)
        # Requantize against the shared scale so int sums are coherent.
        q = torch.clamp(torch.round(g.float() / smax), -127, 127
                        ).to(torch.int32)
        qsum = mesh_lib.all_reduce(q, mesh, axis)
        return (qsum.float() * smax / n).to(g.dtype)

    return tree_lib.map_leaves(reduce_leaf, grads)


class ErrorFeedback:
    """Residual accumulator: feeds quantization error back next step."""

    @staticmethod
    def init(grads: dict) -> dict:
        return tree_lib.map_leaves(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)

    @staticmethod
    def apply(grads: dict, residual: dict):
        """Returns (compensated grads fp32, fn(new_quantized)->new residual)."""
        comp = tree_lib.map_leaves(lambda g, r: g.float() + r, grads,
                                   residual)

        def update(quantized):
            return tree_lib.map_leaves(lambda c, q: c - q.float(), comp,
                                       quantized)

        return comp, update
