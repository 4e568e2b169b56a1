"""Build, binding and launch counts of the LM kernels (K3-K6).

Each kernel is one ``csrc/*.cu`` file with a plain C interface, built by
``nvcc`` for ``sm_90a`` at its first launch (``repro_torch._nvcc``) and
loaded with ctypes. A wrapper counts a launch where it launches its
kernel and nowhere else, so a run can show that its path went through
the kernel; a kernel with more than one route (K4, K5: tensor cores or
CUDA cores, by dtype) also counts the route it launched.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import _nvcc as nvcc_build

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = nvcc_build.BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
              "-ldl")

#: kernel name -> its source in ``csrc/``.
SOURCES = {"gather_rows_kernel": "coalesced_gather.cu",
           "gmm_kernel": "moe_gmm.cu",
           "flash_attention_kernel": "flash_attention.cu",
           "ssd_scan_kernel": "ssd_scan.cu"}
KERNELS = tuple(SOURCES)

# Counts and libraries may be reached from several threads at once: every
# update takes its lock, and a library is built and bound by one thread.
_COUNT_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}  # guarded-by: _COUNT_LOCK
_ROUTE_LAUNCHES: Dict[Tuple[str, str], int] = {}  # guarded-by: _COUNT_LOCK
_LIBS_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded-by: _LIBS_LOCK

_nvcc = nvcc_build.find_nvcc


def launch_count(kernel: str) -> int:
    """Launches of `kernel` (one of :data:`KERNELS`) since the last reset."""
    with _COUNT_LOCK:
        return _LAUNCHES[kernel]


def route_count(kernel: str, route: str) -> int:
    """Launches of `kernel` by `route` (``"tensor_cores"`` or
    ``"cuda_cores"``, as the wrapper names it) since the last reset."""
    with _COUNT_LOCK:
        return _ROUTE_LAUNCHES.get((kernel, route), 0)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            _LAUNCHES[name] = 0
        _ROUTE_LAUNCHES.clear()


def count_launch(kernel: str, route: Optional[str] = None) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[kernel] += 1
        if route is not None:
            key = (kernel, route)
            _ROUTE_LAUNCHES[key] = _ROUTE_LAUNCHES.get(key, 0) + 1


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
    if lib is not None:
        return lib
    with _LIBS_LOCK:
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
