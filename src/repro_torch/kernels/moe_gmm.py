"""K4: the grouped matmul of SW+ sort-compact MoE, on Hopper.

``out[i] = x[i] @ w[block_expert[i // bm]]``: rows come in expert-sorted,
``bm``-aligned groups, so every ``bm``-row block belongs to exactly one
expert. With ``n_rows`` (a device int32 scalar: the rows that belong to a
group, ``ends[-1]`` of ``sort_by_expert``), rows at or past it are zero
and the row blocks past it are skipped; ``None`` means every row, the
reference's behaviour.

On a CUDA tensor :func:`gmm` launches ``csrc/moe_gmm.cu`` (CUDA C++ for
``sm_90a``, float32 sums, the result cast to ``x.dtype``) by one of two
routes, which :func:`route` names:

* ``"tensor_cores"``: bf16 with K and N multiples of 8 and x, w and out
  on 16-byte boundaries (the strides and addresses a TMA map can
  describe). TMA loads into a shared-memory ring, ``wgmma`` on 128 x 128
  output tiles (64 x 128 when ``bm`` is a multiple of 64 but not of 128).
* ``"cuda_cores"``: float32 (the float32 serve is held to its golden file
  at rtol 2e-5, which TF32 cannot meet) and bf16 shapes the first route
  cannot take. A tiled product on the CUDA cores.

No route falls back to another: the route is decided from dtype, shape
and alignment before the launch, and a failed build or launch raises.
Only a CPU tensor takes the plain version (``ref.gmm_ref``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import gmm_ref

KERNEL = "gmm_kernel"
#: Output rows of the smallest CUDA block: ``bm`` must be a multiple of
#: it, so that a block's rows never straddle two experts. The tensor-core
#: route takes 128 rows a block when ``bm`` is a multiple of 128.
TILE_ROWS = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"cuda_cores": 0, "tensor_cores": 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gmm_launch.argtypes = [ptr] * 5 + [i64] * 5 + [i32, i32, ptr]
    lib.gmm_launch.restype = ctypes.c_int


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route a card launch of ``gmm(x, w, ...)`` takes:
    ``"tensor_cores"`` for bf16 whose K and N are multiples of 8 and whose
    x and w start on 16-byte boundaries, else ``"cuda_cores"``."""
    k, n = w.shape[1], w.shape[2]
    if (x.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tensor_cores"
    return "cuda_cores"


def gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
        bm: int = 128, n_rows: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """x: (M, K); w: (E, K, N); block_expert: (M // bm,) int32;
    n_rows: None or a one-element int32 tensor -> (M, N).

    Experts are clamped into [0, E), as the reference's weight gather
    clamps them; ``n_rows`` is clamped into [0, M].
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
    if n_rows is not None and n_rows.numel() != 1:
        raise ValueError(f"n_rows must hold one count, got shape "
                         f"{tuple(n_rows.shape)}")
    if x.device.type == "cpu":
        return gmm_ref(x, w, block_expert, bm, n_rows)
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
    if n_rows is not None:
        _lib.check_tensor("n_rows", n_rows, (torch.int32,), dev)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if e == 0:
        raise ValueError("w has no expert")
    if k == 0:                         # an empty sum: no kernel to launch
        return out.zero_()
    way = route(x, w)
    lib = _lib.library(KERNEL, _bind)
    with torch.cuda.device(dev):
        code = lib.gmm_launch(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
            None if n_rows is None else n_rows.data_ptr(), out.data_ptr(),
            m, k, n, e, bm, _DTYPE_CODE[x.dtype], _ROUTE_CODE[way],
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check_launch(lib, KERNEL, code)
    _lib.count_launch(KERNEL, way)
    return out
