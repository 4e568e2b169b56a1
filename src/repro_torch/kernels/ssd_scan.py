"""K6: the Mamba2 SSD chunked scan, on Hopper.

Per chunk of ``chunk`` steps, with ``cs = cumsum(da)``:
``y = (C Bᵀ ∘ L) xdt + (C ∘ exp(cs)) h_prevᵀ`` and
``h = h_prev exp(cs_last) + xdtᵀ (B ∘ exp(cs_last - cs))``, the state h
starting at 0 and carried across chunks in float32, no D-skip. On a CUDA
tensor :func:`ssd_scan_kernel` launches K6 (``csrc/ssd_scan.cu``, CUDA
C++ for ``sm_90a``, float32 products register-tiled on the CUDA cores) or
raises; only a CPU tensor takes the plain version (``ref.ssd_scan_ref``).
K6 is three launches on the stream: each chunk's own state, the states
passed from chunk to chunk, each chunk's outputs. They share a float32
scratch this wrapper allocates, and count as one launch of K6.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import ssd_scan_ref

KERNEL = "ssd_scan_kernel"
MAX_STATE = 128
MAX_HEAD_DIM = 128
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.ssd_scan_launch.restype = ctypes.c_int


def ssd_scan_kernel(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """xdt: (BH, S, P) dt-weighted input; da: (BH, S) decay logs (<= 0);
    b, c: (BH, S, N). Returns y (BH, S, P) in xdt's dtype. S must be a
    multiple of `chunk` (ValueError where the reference asserts)."""
    if xdt.dim() != 3 or da.dim() != 2 or b.dim() != 3 or c.dim() != 3:
        raise ValueError(f"xdt, b, c must be (BH, S, .) and da (BH, S), "
                         f"got {tuple(xdt.shape)}, {tuple(da.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bh, s, p = xdt.shape
    n = b.shape[-1]
    if (tuple(da.shape) != (bh, s) or tuple(b.shape) != (bh, s, n)
            or tuple(c.shape) != (bh, s, n)):
        raise ValueError(f"da must be ({bh}, {s}) and b, c ({bh}, {s}, N), "
                         f"got {tuple(da.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"S={s} must be a multiple of chunk={chunk}")
    if xdt.device.type == "cpu":
        return ssd_scan_ref(xdt, da, b, c, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"xdt is on {xdt.device}: use cuda or cpu")
    if n > MAX_STATE or p > MAX_HEAD_DIM or chunk > MAX_CHUNK:
        raise ValueError(f"N={n}, P={p} and chunk={chunk} must be at most "
                         f"{MAX_STATE}, {MAX_HEAD_DIM} and {MAX_CHUNK} on "
                         "the card")
    tiles = bh * (s // chunk) * -(-chunk // 64)
    if tiles >= 2 ** 31:
        raise ValueError(f"BH x S/chunk x chunk/64 = {tiles} exceeds one "
                         "launch grid")
    dev = xdt.device
    _lib.check_tensor("xdt", xdt, tuple(_DTYPE_CODE), dev)
    for name, t in (("da", da), ("b", b), ("c", c)):
        _lib.check_tensor(name, t, (xdt.dtype,), dev)
    y = torch.empty_like(xdt)
    if xdt.numel() == 0 or n == 0:
        return y.zero_()
    chunks = bh * (s // chunk)
    # Each chunk's state, then the state it starts from; exp(cs_last).
    states = torch.empty((chunks, p, n), dtype=torch.float32, device=dev)
    decay = torch.empty((chunks,), dtype=torch.float32, device=dev)
    lib = _lib.library(KERNEL, _bind)
    with torch.cuda.device(dev):
        code = lib.ssd_scan_launch(
            xdt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), bh, s, p, n,
            chunk, _DTYPE_CODE[xdt.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check_launch(lib, KERNEL, code)
    _lib.count_launch(KERNEL)
    return y
