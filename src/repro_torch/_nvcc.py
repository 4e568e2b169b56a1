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
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

#: Where every kernel library of the port is built.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

# One lock per library path: threads of one process that need the same
# library build it once (the others wait, then find it), while different
# libraries still build in parallel.
_PATH_LOCKS_LOCK = threading.Lock()
_PATH_LOCKS: Dict[str, threading.Lock] = {}  # guarded-by: _PATH_LOCKS_LOCK


def _path_lock(path: Path) -> threading.Lock:
    with _PATH_LOCKS_LOCK:
        return _PATH_LOCKS.setdefault(str(path), threading.Lock())


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
                 build_dir: Path, nvcc: Callable[[], str],
                 tool: str = "nvcc") -> str:
    """Compile `main` (which includes `deps`) with `flags`, once per hash of
    the sources and flags; returns the library's path. `nvcc` returns the
    compiler's path; `tool` names it in errors (the host C core of
    ``core/warpsim/_native.py`` is built the same way with ``cc``).

    Raises RuntimeError with the compiler's output when the build fails,
    and leaves nothing behind in `build_dir` then. Safe to call from
    several threads and processes at once: within a process one thread
    builds a given library while the others wait; across processes each
    build writes files of its own (named by process and thread) and
    renames them into place, so the last rename wins and no reader sees a
    torn library or log.
    """
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (main, *deps):
        h.update(Path(path).read_bytes())
    so = Path(build_dir) / f"lib{Path(main).stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    with _path_lock(so):
        if so.exists():
            return str(so)
        so.parent.mkdir(parents=True, exist_ok=True)
        own = f"{os.getpid()}.{threading.get_ident()}.tmp"
        tmp = so.with_name(f"{so.name}.{own}")
        tmp_log = so.with_name(f"{so.with_suffix('.log').name}.{own}")
        cmd = [nvcc(), *flags, "-o", str(tmp), str(main)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{tool} failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        tmp_log.write_text(r.stdout + r.stderr, encoding="utf-8")
        os.replace(tmp_log, so.with_suffix(".log"))
        os.replace(tmp, so)     # atomic: the library appears whole
    return str(so)


def build_log(so_path: str) -> str:
    """The compiler's output of the build that made `so_path`."""
    log = Path(so_path).with_suffix(".log")
    return log.read_text(encoding="utf-8") if log.exists() else ""
