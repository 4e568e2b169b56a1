"""Build, binding and launch counts of the LM kernels (K3, K4).

Each kernel is one ``csrc/*.cu`` file with a plain C interface, built by
``nvcc`` for ``sm_90a`` at its first launch (``repro_torch._nvcc``) and
loaded with ctypes. A wrapper counts a launch where it launches its
kernel and nowhere else, so a run can show that its path went through
the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict

import torch

from repro_torch import _nvcc as nvcc_build

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = nvcc_build.BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> its source in ``csrc/``.
SOURCES = {"gather_rows_kernel": "coalesced_gather.cu",
           "gmm_kernel": "moe_gmm.cu"}
KERNELS = tuple(SOURCES)

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}

_nvcc = nvcc_build.find_nvcc


def launch_count(kernel: str) -> int:
    """Launches of `kernel` (one of :data:`KERNELS`) since the last reset."""
    return _LAUNCHES[kernel]


def reset_launch_counts() -> None:
    for name in KERNELS:
        _LAUNCHES[name] = 0


def count_launch(kernel: str) -> None:
    _LAUNCHES[kernel] += 1


def build(kernel: str) -> str:
    """Build `kernel`'s library (once per source hash); returns its path.
    Raises RuntimeError with nvcc's output when the build fails."""
    return nvcc_build.build_shared(CSRC / SOURCES[kernel], [], NVCC_FLAGS,
                                   BUILD_DIR, _nvcc)


def library(kernel: str, bind: Callable[[ctypes.CDLL], None]
            ) -> ctypes.CDLL:
    """`kernel`'s library, built and loaded at first use; `bind` declares
    its functions' argument and result types."""
    lib = _LIBS.get(kernel)
    if lib is None:
        lib = ctypes.CDLL(build(kernel))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        bind(lib)
        _LIBS[kernel] = lib
    return lib


def check_launch(lib, kernel: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{kernel} launch failed: cuda error {code} "
                           f"({msg})")


def check_tensor(name: str, x: torch.Tensor, dtypes,
                 device: torch.device) -> None:
    """Raise ValueError unless `x` lies on `device`, has one of `dtypes`
    and is contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} is {x.dtype}, expected one of "
                         f"{[str(d) for d in dtypes]}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
