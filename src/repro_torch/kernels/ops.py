"""Dispatch wrappers of the LM kernels, with the reference's signatures
(``repro.kernels.ops``).

``coalesced_gather`` builds the per-destination-row source map and
launches K3 at every size: the Hopper kernel reads rows straight from
device memory, so the reference's VMEM budget and its XLA fallback have no
counterpart here. ``moe_gmm`` launches K4, ``flash_attention`` K5 and ``ssd_scan`` K6.

No kernel has a backward: the reference cannot differentiate its
``pallas_call`` (``jax.grad`` through it raises), and the port's kernels
are bound with ctypes, so their outputs would carry no ``grad_fn`` and
every gradient through them would be lost without a word. Each wrapper
raises ``NotImplementedError`` instead when autograd records and any
input requires grad, on the CPU and the card alike. The serve runs under
``torch.no_grad()``; the kernel bench's inputs do not require grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import coalesced_gather as _gather_k
from repro_torch.kernels import flash_attention as _flash_k
from repro_torch.kernels import moe_gmm as _gmm_k
from repro_torch.kernels import ssd_scan as _ssd_k


def _no_backward(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise NotImplementedError if autograd would need `kernel`'s
    backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward (as the reference's pallas_call has "
            f"no transpose rule): call it under torch.no_grad() or on "
            f"tensors that do not require grad")


def moe_gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
            block: int = 128, n_rows: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Grouped matmul over BM-aligned expert groups; rows at or past
    ``n_rows`` (a device int32 scalar, ``None`` for every row) are zero
    and their row blocks are skipped."""
    _no_backward("moe_gmm", x, w)
    return _gmm_k.gmm(x, w, block_expert.to(torch.int32), bm=block,
                      n_rows=n_rows)


def row_maps(src: torch.Tensor, dest: torch.Tensor, t_pad: int,
             valid: Optional[torch.Tensor] = None):
    """Per destination row: its source row and whether it has one
    (``row_src``, ``row_valid``, both (t_pad,) int32), from
    ``out[dest[i]] = x[src[i]]`` for every i (where `valid`, if given)."""
    dest = dest.long()
    row_src = torch.zeros((t_pad,), dtype=torch.int32, device=dest.device)
    row_src[dest] = src.to(torch.int32)
    row_valid = torch.zeros((t_pad,), dtype=torch.int32, device=dest.device)
    row_valid[dest] = 1 if valid is None else valid.to(torch.int32)
    return row_src, row_valid


def coalesced_gather(x: torch.Tensor, src: torch.Tensor, dest: torch.Tensor,
                     t_pad: int, block: int = 128,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[dest[i]] = x[src[i]]; rows of `out` not hit by `dest` (or hit
    where `valid` is False) are zero, and K3 reads no row of `x` for them.

    `block` is the reference's row-block size; the Hopper kernel works row
    by row and does not need it.
    """
    del block
    _no_backward("coalesced_gather", x)
    row_src, row_valid = row_maps(src, dest, t_pad, valid)
    return _gather_k.gather_rows(x, row_src, row_valid, t_pad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bq: int = 128,
                    bkv: int = 128) -> torch.Tensor:
    """(BH, S, hd) flash attention with (BQ, BKV) tile granularity."""
    _no_backward("flash_attention", q, k, v)
    return _flash_k.flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)


def ssd_scan(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Mamba2 SSD chunked scan: three launches over a float32 state
    scratch the wrapper allocates: ``ssd_scan_states`` (each chunk's
    state as if it started from zero), ``ssd_scan_pass`` (the state each
    chunk starts from, carried over the chunks in order) and
    ``ssd_scan_outputs`` (each chunk's outputs from its start state)."""
    _no_backward("ssd_scan", xdt, da, b, c)
    return _ssd_k.ssd_scan_kernel(xdt, da, b, c, chunk=chunk)
