"""Build one CUDA source into a shared library with a plain C interface.

Every kernel of the port is compiled the same way: ``nvcc`` for
``sm_90a`` into ``<repo>/build/repro_torch/``, at first use, and bound
with ctypes by the module that launches it. The library's name carries a
hash of the sources and flags, so an edit rebuilds it and an unchanged
tree reuses it. nvcc's own output (with ``-Xptxas -v``: registers, shared
memory and spills per kernel) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence

#: Where every kernel library of the port is built.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"


def find_nvcc() -> str:
    """Path of ``nvcc`` on PATH or under PyTorch's CUDA_HOME; raises."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def build_shared(main: Path, deps: Sequence[Path], flags: Sequence[str],
                 build_dir: Path, nvcc: Callable[[], str]) -> str:
    """Compile `main` (which includes `deps`) with `flags`, once per hash of
    the sources and flags; returns the library's path.

    Raises RuntimeError with nvcc's output when the build fails, and
    leaves nothing behind in `build_dir` then.
    """
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (main, *deps):
        h.update(Path(path).read_bytes())
    so = Path(build_dir) / f"lib{Path(main).stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-o", str(tmp), str(main)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    so.with_suffix(".log").write_text(r.stdout + r.stderr, encoding="utf-8")
    os.replace(tmp, so)     # atomic: concurrent builds race benignly
    return str(so)


def build_log(so_path: str) -> str:
    """nvcc's output of the build that made `so_path`."""
    log = Path(so_path).with_suffix(".log")
    return log.read_text(encoding="utf-8") if log.exists() else ""
