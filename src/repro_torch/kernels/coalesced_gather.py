"""K3: the SW+ row gather ("dynamic coalescing"), on Hopper.

``out[j] = x[row_src[j]] if row_valid[j] else 0`` for ``j < t_pad``:
token rows land in the expert-sorted, block-aligned layout of SW+
dispatch. On a CUDA tensor :func:`gather_rows` launches
``gather_rows_kernel`` (``csrc/coalesced_gather.cu``, CUDA C++ for
``sm_90a``) or raises; only a CPU tensor takes the plain version
(``ref.gather_rows_ref``). The kernel reads rows straight from device
memory, so it has none of the reference's VMEM budget and runs at every
size.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import gather_rows_ref

KERNEL = "gather_rows_kernel"
_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gather_rows_launch.argtypes = [ptr] * 4 + [i64] * 3 + [
        ctypes.c_int, ptr]
    lib.gather_rows_launch.restype = ctypes.c_int


def _word_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest copy word (16, 8, 4, 2 or 1 bytes) that divides the row
    size and both base addresses."""
    for wb in (16, 8, 4, 2):
        if row_bytes % wb == 0 and all(p % wb == 0 for p in ptrs):
            return wb
    return 1


def gather_rows(x: torch.Tensor, row_src: torch.Tensor,
                row_valid: torch.Tensor, t_pad: int) -> torch.Tensor:
    """out[j] = x[row_src[j]] if row_valid[j] else 0, j in [0, t_pad).

    x: (T, D) float32 or bfloat16; row_src, row_valid: (t_pad,) int32.
    Source rows are clamped into [0, T), as the reference's gather clamps
    them.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    for name, m in (("row_src", row_src), ("row_valid", row_valid)):
        if tuple(m.shape) != (t_pad,):
            raise ValueError(f"{name} has shape {tuple(m.shape)}, expected "
                             f"({t_pad},)")
    if x.device.type == "cpu":
        return gather_rows_ref(x, row_src, row_valid, t_pad)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: use cuda or cpu")
    dev = x.device
    _lib.check_tensor("x", x, _DTYPES, dev)
    _lib.check_tensor("row_src", row_src, (torch.int32,), dev)
    _lib.check_tensor("row_valid", row_valid, (torch.int32,), dev)
    t, d = x.shape
    out = torch.empty((t_pad, d), dtype=x.dtype, device=dev)
    row_bytes = d * x.element_size()
    if t_pad == 0 or row_bytes == 0:
        return out
    lib = _lib.library(KERNEL, _bind)
    with torch.cuda.device(dev):
        code = lib.gather_rows_launch(
            x.data_ptr(), row_src.data_ptr(), row_valid.data_ptr(),
            out.data_ptr(), t, row_bytes, t_pad,
            _word_bytes(row_bytes, x.data_ptr(), out.data_ptr()),
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check_launch(lib, KERNEL, code)
    _lib.count_launch(KERNEL)
    return out
