"""K5: flash attention with (BQ, BKV) tile granularity, on Hopper.

``out = softmax(q kᵀ / sqrt(hd), causal mask) v`` over q, k, v of shape
(BH, S, hd), batch and heads flattened. On a CUDA tensor
:func:`flash_attention` launches ``csrc/flash_attention.cu`` (CUDA C++
for ``sm_90a``: float32 statistics and sums, the result cast to
``q.dtype``) or raises; only a CPU tensor takes the plain version
(``ref.flash_attention_ref``). The route is chosen by dtype and named by
:func:`route`:

* ``"tensor_cores"`` for bf16: ``mma.sync`` bf16 products in
  FlashAttention-2's layout, P rounded to bf16 as the second product's
  operand;
* ``"cuda_cores"`` for float32: register-tiled float32 products, since
  the reference's float32 tolerance (2e-5) rules out TF32.

Both need hd a multiple of 8 and at most 128 and q, k, v on 16-byte
boundaries (``cp.async`` copies 16 bytes at a time); anything else raises.
The kernels' own tiling is fixed (64 query rows by 64 keys); ``bq`` and
``bkv`` are checked as the reference asserts them and do not change the
result beyond float32 rounding, as the reference's tile-invariance test
requires.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import flash_attention_ref

KERNEL = "flash_attention_kernel"
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE = {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores"}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 4 + [
        ctypes.c_float, i32, i32, ptr]
    lib.flash_attention_launch.restype = ctypes.c_int


def route(q: torch.Tensor) -> str:
    """The route a card launch on `q` takes, by its dtype."""
    if q.dtype not in _ROUTE:
        raise ValueError(f"q is {q.dtype}, expected one of "
                         f"{[str(d) for d in _ROUTE]}")
    return _ROUTE[q.dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bq: int = 128, bkv: int = 128
                    ) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd) -> (BH, Sq, hd) in q's dtype.

    As in the reference, ``bq = min(bq, Sq)`` and ``bkv = min(bkv, Sk)``
    must divide Sq and Sk (ValueError where the reference asserts).
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (bh, sk, hd) or tuple(v.shape) != (bh, sk, hd):
        raise ValueError(f"k and v must be ({bh}, Sk, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    bq, bkv = min(bq, sq), min(bkv, sk)
    if bq <= 0 or bkv <= 0 or sq % bq or sk % bkv:
        raise ValueError(f"tiles ({bq}, {bkv}) must divide (Sq, Sk) = "
                         f"({sq}, {sk})")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}: use cuda or cpu")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"hd={hd} must be a multiple of 8 and at most "
                         f"{MAX_HEAD_DIM} on the card")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds one launch grid")
    dev = q.device
    _lib.check_tensor("q", q, tuple(_DTYPE_CODE), dev)
    _lib.check_tensor("k", k, (q.dtype,), dev)
    _lib.check_tensor("v", v, (q.dtype,), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib.library(KERNEL, _bind)
    with torch.cuda.device(dev):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            sq, sk, hd, 1.0 / hd ** 0.5, int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _lib.check_launch(lib, KERNEL, code)
    _lib.count_launch(KERNEL, route(q))
    return out
