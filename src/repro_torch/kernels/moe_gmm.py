"""K4: the grouped matmul of SW+ sort-compact MoE, on Hopper.

``out[i] = x[i] @ w[block_expert[i // bm]]``: rows come in expert-sorted,
``bm``-aligned groups, so every ``bm``-row block belongs to exactly one
expert. On a CUDA tensor :func:`gmm` launches ``gmm_kernel``
(``csrc/moe_gmm.cu``, CUDA C++ for ``sm_90a``: float32 sums, the result
cast to ``x.dtype``) or raises; only a CPU tensor takes the plain version
(``ref.gmm_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import gmm_ref

KERNEL = "gmm_kernel"
#: Output rows of one CUDA block: ``bm`` must be a multiple of it, so that
#: a block's rows never straddle two experts.
TILE_ROWS = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gmm_launch.argtypes = [ptr] * 4 + [i64] * 5 + [ctypes.c_int, ptr]
    lib.gmm_launch.restype = ctypes.c_int


def gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
        bm: int = 128) -> torch.Tensor:
    """x: (M, K); w: (E, K, N); block_expert: (M // bm,) int32 -> (M, N).

    Experts are clamped into [0, E), as the reference's weight gather
    clamps them.
    """
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x must be (M, K) and w (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    e, kw, n = w.shape
    if k != kw:
        raise ValueError(f"x is (M, {k}) but w is (E, {kw}, N)")
    if bm <= 0 or m % bm:
        raise ValueError(f"M={m} must be a multiple of bm={bm}")
    if tuple(block_expert.shape) != (m // bm,):
        raise ValueError(f"block_expert has shape "
                         f"{tuple(block_expert.shape)}, expected "
                         f"({m // bm},)")
    if x.device.type == "cpu":
        return gmm_ref(x, w, block_expert, bm)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: use cuda or cpu")
    if bm % TILE_ROWS:
        raise ValueError(f"bm={bm} must be a multiple of {TILE_ROWS} on the "
                         "card")
    if m // TILE_ROWS > 65535:
        raise ValueError(f"M={m} exceeds one launch grid")
    dev = x.device
    dtypes = tuple(_DTYPE_CODE)
    _lib.check_tensor("x", x, dtypes, dev)
    _lib.check_tensor("w", w, (x.dtype,), dev)
    _lib.check_tensor("block_expert", block_expert, (torch.int32,), dev)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if e == 0:
        raise ValueError("w has no expert")
    lib = _lib.library(KERNEL, _bind)
    with torch.cuda.device(dev):
        code = lib.gmm_launch(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
            out.data_ptr(), m, k, n, e, bm, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check_launch(lib, KERNEL, code)
    _lib.count_launch(KERNEL)
    return out
