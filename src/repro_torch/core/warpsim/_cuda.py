"""The trace-family launch on the card: K1 + K2 in CUDA C++ for Hopper.

Counterpart of the reference's Pallas device program. One launch pair
simulates a whole *trace family*: every (expansion key x machine variant)
unit derived from one ThreadTrace. The host marshals each unit's
:class:`WarpStream` columns plus the machine's scalars into concatenated
tensors (:func:`marshal`), then

* ``ws_prep_kernel`` (K1) maps every block of every unit to its memory
  controller, L1 set and store occupancy, and
* ``ws_family_kernel`` (K2) runs the scheduling recurrence, one CUDA thread
  per unit, and returns ``(raw_cycles, offchip, merged, l1_hits)`` per unit.

Both live in ``csrc/warpsim_family.cu`` over the ``__host__ __device__``
code of ``csrc/warpsim_family.cuh``. They are built with ``nvcc`` at first
use into ``<repo>/build/repro_torch/`` (keyed by a hash of the sources and
flags) and bound through ctypes. Beside each kernel sits its plain PyTorch
version (:func:`prep_ref`, :func:`simulate_family_ref`); a wrapper takes
the plain version only for tensors on the CPU. On a CUDA tensor it launches
the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.warpsim.config import MachineConfig

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
_SOURCES = ("warpsim_family.cu", "warpsim_family.cuh")

# Column names of the per-unit parameter tables, in the order of the
# WS_* enums in csrc/warpsim_family.cuh.
UP_COLS = ("warp_off", "op_off", "blk_off", "n_warps", "n_blocks", "n_sms",
           "nctrl", "n_sets", "ways", "ideal", "n_slots", "fscr_off",
           "iscr_off")
FP_COLS = ("hit_lat", "depth", "dram_lat", "svc_unit")
_UP = {name: i for i, name in enumerate(UP_COLS)}
_FP = {name: i for i, name in enumerate(FP_COLS)}

KERNELS = ("ws_prep_kernel", "ws_family_kernel")

# Launches per kernel, counted by the wrappers where they launch.
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[str] = None


def launch_count(kernel: str) -> int:
    """Launches of `kernel` (one of :data:`KERNELS`) since the last reset."""
    return _LAUNCHES[kernel]


def reset_launch_counts() -> None:
    for name in KERNELS:
        _LAUNCHES[name] = 0


def status() -> dict:
    """Whether a card is visible, which library is loaded, launch counts."""
    return {
        "cuda_available": torch.cuda.is_available(),
        "library": _LIB_PATH,
        "launches": dict(_LAUNCHES),
    }


def resolve_engine(engine: str, device) -> str:
    """``"cuda"`` (the kernels) on a CUDA device, ``"torch"`` (the plain
    versions) on the CPU. ``"auto"`` resolves from `device`; an engine that
    does not match the device raises."""
    dev = torch.device(device)
    want = {"cuda": "cuda", "cpu": "torch"}.get(dev.type)
    if want is None:
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    if engine == "auto":
        return want
    if engine not in ("cuda", "torch"):
        raise ValueError(f"unknown engine {engine!r}; use auto|cuda|torch")
    if engine != want:
        raise ValueError(f"engine {engine!r} does not run on device {dev}")
    return engine


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the family kernels")


def build() -> str:
    """Build the kernel library (once per source hash); returns its path.

    Raises RuntimeError with nvcc's output when the build fails.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libwarpsim_family_{h.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / "warpsim_family.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)     # atomic: concurrent builds race benignly
    return str(so)


def _lib() -> ctypes.CDLL:
    global _LIB, _LIB_PATH
    if _LIB is None:
        path = build()
        lib = ctypes.CDLL(path)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ws_prep_launch.argtypes = [ptr] * 7 + [i64, i64, ptr]
        lib.ws_prep_launch.restype = ctypes.c_int
        lib.ws_family_launch.argtypes = [ptr] * 16 + [i64, ptr]
        lib.ws_family_launch.restype = ctypes.c_int
        lib.ws_error_string.argtypes = [ctypes.c_int]
        lib.ws_error_string.restype = ctypes.c_char_p
        _LIB, _LIB_PATH = lib, path
    return _LIB


def _check_launch(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    if code != 0:
        msg = lib.ws_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{kernel} launch failed: cuda error {code} "
                           f"({msg})")


# ---------------------------------------------------------------------------
# Host marshalling
# ---------------------------------------------------------------------------


class StreamCols(NamedTuple):
    """The WarpStream columns the scheduling loop reads."""

    n_warps: int
    op_start: np.ndarray    # int64[n_warps+1] CSR row offsets
    issue: np.ndarray       # int64[n_ops]
    kind: np.ndarray        # int8[n_ops] 0 compute / 1 load / 2 store
    blk_off: np.ndarray     # int64[n_ops]
    blk_len: np.ndarray     # int64[n_ops]
    blocks: np.ndarray      # int64[n_blocks]
    nbytes: np.ndarray      # int64[n_blocks]


def stream_cols(stream) -> StreamCols:
    return StreamCols(
        n_warps=int(stream.n_warps),
        op_start=np.ascontiguousarray(stream.op_start, dtype=np.int64),
        issue=np.ascontiguousarray(stream.issue, dtype=np.int64),
        kind=np.ascontiguousarray(stream.kind, dtype=np.int8),
        blk_off=np.ascontiguousarray(stream.blk_off, dtype=np.int64),
        blk_len=np.ascontiguousarray(stream.blk_len, dtype=np.int64),
        blocks=np.ascontiguousarray(stream.blocks, dtype=np.int64),
        nbytes=np.ascontiguousarray(stream.nbytes, dtype=np.int64))


def check_stream_cols(st: StreamCols) -> None:
    """Raise ValueError unless the columns index one another: the kernels
    read them without bounds checks."""
    n_ops, n_blk = len(st.issue), len(st.blocks)
    start = st.op_start
    if (len(start) < 1 or len(start) != st.n_warps + 1 or start[0] != 0
            or start[-1] != n_ops or np.any(np.diff(start) < 0)):
        raise ValueError("op_start is not a CSR offset array over the ops")
    if not len(st.kind) == len(st.blk_off) == len(st.blk_len) == n_ops \
            or len(st.nbytes) != n_blk:
        raise ValueError("op or block columns differ in length")
    if np.any((st.kind < 0) | (st.kind > 2)):
        raise ValueError("kind holds a value other than 0, 1 or 2")
    if (np.any(st.blk_off < 0) or np.any(st.blk_len < 0)
            or np.any(st.blk_off + st.blk_len > n_blk)):
        raise ValueError("blk_off/blk_len index outside the block pool")
    if np.any(st.blocks < 0):
        raise ValueError("block ids must be non-negative")


def machine_scalars(cfg: MachineConfig) -> dict:
    """The machine parameters the family kernels read."""
    if min(cfg.num_sms, cfg.num_mem_ctrls, cfg.l1_ways) <= 0 \
            or cfg.l1_sets <= 0:
        raise ValueError(f"machine {cfg.name!r} has no L1 set, memory "
                         "controller or SM to simulate")
    return dict(
        n_sms=cfg.num_sms, nctrl=cfg.num_mem_ctrls, n_sets=cfg.l1_sets,
        ways=cfg.l1_ways, ideal=int(bool(cfg.ideal_coalescing)),
        hit_lat=float(cfg.l1_hit_latency), depth=float(cfg.pipeline_depth),
        dram_lat=float(cfg.dram_latency_cycles),
        svc_unit=float(cfg.dram_cycles_per_transaction))


@dataclasses.dataclass
class Family:
    """One family launch's inputs, on one device.

    ``up``/``fp`` are the per-unit parameter tables (:data:`UP_COLS`,
    :data:`FP_COLS`); the other tensors are the units' columns concatenated
    in unit order, ops and blocks indexed from 0 within their unit.
    """

    up: torch.Tensor        # int64[U, len(UP_COLS)]
    fp: torch.Tensor        # float64[U, len(FP_COLS)]
    next0: torch.Tensor     # int64[sum warps]  first op of each warp
    end: torch.Tensor       # int64[sum warps]  one past its last op
    issue: torch.Tensor     # int64[sum ops]
    kind: torch.Tensor      # int8[sum ops]
    blk_off: torch.Tensor   # int64[sum ops]
    blk_len: torch.Tensor   # int64[sum ops]
    blocks: torch.Tensor    # int64[sum blocks]
    nbytes: torch.Tensor    # int64[sum blocks]
    slot: torch.Tensor      # int64[sum blocks]  dense id of the block
    fscr_len: int           # doubles of scratch the recurrence needs
    iscr_len: int           # int64s of scratch the recurrence needs
    max_blocks: int         # most blocks of any unit

    @property
    def n_units(self) -> int:
        return int(self.up.shape[0])

    @property
    def device(self) -> torch.device:
        return self.up.device


def marshal(units: Sequence[Tuple[StreamCols, MachineConfig]],
            device="cuda") -> Family:
    """Concatenate units ``[(StreamCols, MachineConfig), ...]`` into one
    :class:`Family` on `device`.

    Keeps the reference's per-unit geometry: the SW+ outstanding table is
    dense over the stream's unique blocks (``np.unique`` remap to slots),
    warps map to SMs as ``min(w * n_sms // n_warps, n_sms - 1)`` (in the
    kernel) and ``n_sets = l1_size_bytes // (transaction_bytes * ways)``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is "
                           "available")
    if not units:
        raise ValueError("a family launch needs at least one unit")
    if len(units) > 65535:
        raise ValueError(f"{len(units)} units exceed one launch grid")
    slot_cache: dict = {}
    up = np.zeros((len(units), len(UP_COLS)), dtype=np.int64)
    fp = np.zeros((len(units), len(FP_COLS)), dtype=np.float64)
    cols: Dict[str, List[np.ndarray]] = {
        k: [] for k in ("next0", "end", "issue", "kind", "blk_off",
                        "blk_len", "blocks", "nbytes", "slot")}
    warp_off = op_off = blk_off = fscr = iscr = 0
    for u, (st, cfg) in enumerate(units):
        m = machine_scalars(cfg)
        nw = st.n_warps
        n_ops, n_blk = len(st.issue), len(st.blocks)
        slot = slot_cache.get(id(st.blocks))
        if slot is None:
            check_stream_cols(st)
            _, inv = np.unique(st.blocks, return_inverse=True)
            slot = slot_cache[id(st.blocks)] = inv.astype(np.int64)
        n_slots = max(1, int(slot.max(initial=0)) + 1)
        lines = m["n_sms"] * m["n_sets"] * m["ways"]
        row = dict(warp_off=warp_off, op_off=op_off, blk_off=blk_off,
                   n_warps=nw, n_blocks=n_blk, n_slots=n_slots,
                   fscr_off=fscr, iscr_off=iscr,
                   **{k: m[k] for k in ("n_sms", "nctrl", "n_sets", "ways",
                                        "ideal")})
        up[u] = [row[k] for k in UP_COLS]
        fp[u] = [m[k] for k in FP_COLS]
        cols["next0"].append(st.op_start[:nw])
        cols["end"].append(st.op_start[1:nw + 1])
        cols["issue"].append(st.issue)
        cols["kind"].append(st.kind)
        cols["blk_off"].append(st.blk_off)
        cols["blk_len"].append(st.blk_len)
        cols["blocks"].append(st.blocks)
        cols["nbytes"].append(st.nbytes)
        cols["slot"].append(slot)
        warp_off += nw
        op_off += n_ops
        blk_off += n_blk
        # Scratch sizes, in the layout ws_simulate_unit carves them.
        fscr += (nw + m["n_sms"] + m["nctrl"] + lines
                 + (m["n_sms"] * n_slots if m["ideal"] else 0))
        iscr += nw + m["n_sms"] + 2 * lines

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return Family(
        up=t(up), fp=t(fp),
        **{k: t(np.concatenate(v)) for k, v in cols.items()},
        fscr_len=fscr, iscr_len=iscr,
        max_blocks=int(up[:, _UP["n_blocks"]].max()))


# ---------------------------------------------------------------------------
# K1: block prep
# ---------------------------------------------------------------------------


def prep(fam: Family) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per block of every unit: ``(ctrl, si, ssvc)``. Launches K1 on a CUDA
    family; runs :func:`prep_ref` on a CPU one."""
    if fam.device.type == "cpu":
        return prep_ref(fam.up, fam.fp, fam.blocks, fam.nbytes)
    _check_family(fam)
    n = fam.blocks.shape[0]
    ctrl = torch.empty(n, dtype=torch.int64, device=fam.device)
    si = torch.empty(n, dtype=torch.int64, device=fam.device)
    ssvc = torch.empty(n, dtype=torch.float64, device=fam.device)
    lib = _lib()
    with torch.cuda.device(fam.device):
        code = lib.ws_prep_launch(
            fam.up.data_ptr(), fam.fp.data_ptr(), fam.blocks.data_ptr(),
            fam.nbytes.data_ptr(), ctrl.data_ptr(), si.data_ptr(),
            ssvc.data_ptr(), fam.n_units, fam.max_blocks,
            torch.cuda.current_stream(fam.device).cuda_stream)
    _check_launch(lib, "ws_prep_kernel", code)
    _LAUNCHES["ws_prep_kernel"] += 1
    return ctrl, si, ssvc


def prep_ref(up: torch.Tensor, fp: torch.Tensor, blocks: torch.Tensor,
             nbytes: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``ctrl = b % nctrl``, ``si = b % n_sets``,
    ``ssvc = svc * (max(nbytes, 32) / 64.0)``, per unit's blocks (which lie
    contiguously in unit order)."""
    uid = torch.repeat_interleave(
        torch.arange(up.shape[0], device=up.device), up[:, _UP["n_blocks"]])
    ctrl = blocks % up[uid, _UP["nctrl"]]
    si = blocks % up[uid, _UP["n_sets"]]
    ssvc = fp[uid, _FP["svc_unit"]] * (
        torch.clamp_min(nbytes, 32).to(torch.float64) / 64.0)
    return ctrl, si, ssvc


# ---------------------------------------------------------------------------
# K2: the scheduling recurrence
# ---------------------------------------------------------------------------


def simulate_family(fam: Family, ctrl: torch.Tensor, si: torch.Tensor,
                    ssvc: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(raw_cycles float64[U], counts int64[U, 3])`` with counts
    ``(offchip, merged, l1_hits)``. Launches K2 on a CUDA family; runs
    :func:`simulate_family_ref` on a CPU one."""
    if fam.device.type == "cpu":
        return simulate_family_ref(fam, ctrl, si, ssvc)
    _check_family(fam)
    n = fam.blocks.shape[0]
    for name, x, dtype in (("ctrl", ctrl, torch.int64),
                           ("si", si, torch.int64),
                           ("ssvc", ssvc, torch.float64)):
        _check_tensor(name, x, dtype, fam.device, (n,))
    dev = fam.device
    fscr = torch.empty(max(fam.fscr_len, 1), dtype=torch.float64, device=dev)
    iscr = torch.empty(max(fam.iscr_len, 1), dtype=torch.int64, device=dev)
    cycles = torch.empty(fam.n_units, dtype=torch.float64, device=dev)
    counts = torch.empty((fam.n_units, 3), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.ws_family_launch(
            fam.up.data_ptr(), fam.fp.data_ptr(), fam.next0.data_ptr(),
            fam.end.data_ptr(), fam.issue.data_ptr(), fam.kind.data_ptr(),
            fam.blk_off.data_ptr(), fam.blk_len.data_ptr(),
            fam.slot.data_ptr(), ctrl.data_ptr(), si.data_ptr(),
            ssvc.data_ptr(), fscr.data_ptr(), iscr.data_ptr(),
            cycles.data_ptr(), counts.data_ptr(), fam.n_units,
            torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, "ws_family_kernel", code)
    _LAUNCHES["ws_family_kernel"] += 1
    return cycles, counts


def simulate_family_ref(fam: Family, ctrl: torch.Tensor, si: torch.Tensor,
                        ssvc: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2: the recurrence of ``ws_simulate_unit``, unit by unit.

    The recurrence is sequential scalar code with no tensor form, so the
    plain version walks it in Python over the tensors' values, with the
    kernel's state layout (dense L1 ways, dense outstanding table) and the
    same double operations in the same order.
    """
    up = fam.up.tolist()
    fp = fam.fp.tolist()
    next0, end = fam.next0.tolist(), fam.end.tolist()
    issue, kind = fam.issue.tolist(), fam.kind.tolist()
    blk_off, blk_len = fam.blk_off.tolist(), fam.blk_len.tolist()
    slot_l, ctrl_l, si_l = fam.slot.tolist(), ctrl.tolist(), si.tolist()
    ssvc_l = ssvc.tolist()
    inf = float("inf")
    cycles: List[float] = []
    counts: List[List[int]] = []
    for p, f in zip(up, fp):
        (wo, oo, bo, nw, _nb, n_sms, nctrl, n_sets, ways, ideal, n_slots,
         _fo, _io) = p
        hit_lat, depth, dram_lat, svc_unit = f
        nxt = next0[wo:wo + nw]
        wend = end[wo:wo + nw]
        ready = [0.0 if a < b else inf for a, b in zip(nxt, wend)]
        issue_free = [0.0] * n_sms
        tick_ctr = [0] * n_sms
        ctrl_free = [0.0] * nctrl
        lines = n_sms * n_sets * ways
        tags = [-1] * lines
        ticks = [0] * lines
        fills = [0.0] * lines
        outst = [-inf] * (n_sms * n_slots) if ideal else []
        offchip = merged = l1_hits = 0
        while True:
            w = -1
            ready_t = inf
            for j in range(nw):
                if ready[j] < ready_t:
                    ready_t = ready[j]
                    w = j
            if w < 0:
                break
            sm = min(w * n_sms // nw, n_sms - 1)
            i = nxt[w]
            free_t = issue_free[sm]
            t_acc = (ready_t if ready_t > free_t else free_t) + float(
                issue[oo + i])
            issue_free[sm] = t_acc
            o = bo + blk_off[oo + i]
            n_blk = blk_len[oo + i]
            k = kind[oo + i]
            if k == 0:
                warp_ready = t_acc + depth
            elif k == 1:
                done = t_acc + hit_lat
                tick = tick_ctr[sm]
                for b in range(o, o + n_blk):
                    s = slot_l[b]
                    row = (sm * n_sets + si_l[b]) * ways
                    tick += 1
                    way = -1
                    for y in range(ways):
                        if tags[row + y] == s:
                            way = y
                            break
                    if way >= 0:
                        ticks[row + way] = tick
                        if fills[row + way] <= t_acc:
                            l1_hits += 1
                            continue
                    if ideal:
                        out = outst[sm * n_slots + s]
                        if out > t_acc:
                            merged += 1
                            if out > done:
                                done = out
                            continue
                    c = ctrl_l[b]
                    cf = ctrl_free[c]
                    start = cf if cf > t_acc else t_acc
                    ctrl_free[c] = start + svc_unit
                    completion = start + dram_lat + svc_unit
                    offchip += 1
                    tick += 1
                    if way >= 0:
                        if completion < fills[row + way]:
                            fills[row + way] = completion
                    else:
                        for y in range(ways):
                            if tags[row + y] == -1:
                                way = y
                                break
                        if way < 0:
                            way = 0
                            for y in range(1, ways):
                                if ticks[row + y] < ticks[row + way]:
                                    way = y
                        tags[row + way] = s
                        fills[row + way] = completion
                    ticks[row + way] = tick
                    if ideal:
                        outst[sm * n_slots + s] = completion
                    if completion > done:
                        done = completion
                tick_ctr[sm] = tick
                warp_ready = done
            else:
                for b in range(o, o + n_blk):
                    c = ctrl_l[b]
                    cf = ctrl_free[c]
                    ctrl_free[c] = (cf if cf > t_acc else t_acc) + ssvc_l[b]
                offchip += n_blk
                warp_ready = t_acc + hit_lat
            nxt[w] = i + 1
            ready[w] = warp_ready if i + 1 < wend[w] else inf
        cyc = 0.0
        for x in issue_free:
            if x > cyc:
                cyc = x
        cycles.append(cyc)
        counts.append([offchip, merged, l1_hits])
    return (torch.tensor(cycles, dtype=torch.float64),
            torch.tensor(counts, dtype=torch.int64).reshape(-1, 3))


def _check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype,
                  device: torch.device, shape=None) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")


def _check_family(fam: Family) -> None:
    if fam.device.type != "cuda":
        raise ValueError(f"family is on {fam.device}: the kernels run on a "
                         "CUDA device")
    i64 = torch.int64
    for name, dtype in (("up", i64), ("fp", torch.float64), ("next0", i64),
                        ("end", i64), ("issue", i64), ("kind", torch.int8),
                        ("blk_off", i64), ("blk_len", i64), ("blocks", i64),
                        ("nbytes", i64), ("slot", i64)):
        _check_tensor(name, getattr(fam, name), dtype, fam.device)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _simulate(fam: Family, engine: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 then K2 on `fam`: the kernels for ``engine="cuda"``, their plain
    versions for ``engine="torch"`` (`engine` already resolved)."""
    if engine == "cuda":
        return simulate_family(fam, *prep(fam))
    return simulate_family_ref(
        fam, *prep_ref(fam.up, fam.fp, fam.blocks, fam.nbytes))


def run_family(pairs, device="cuda", engine: str = "auto"
               ) -> List[Tuple[float, int, int, int]]:
    """Simulate a trace family in ONE launch of each kernel.

    ``pairs`` is ``[(WarpStream, MachineConfig), ...]`` — every expansion
    key x machine variant of one ThreadTrace (streams may repeat across
    variants that share an expansion). Returns ``(raw_cycles, offchip,
    merged, l1_hits)`` per pair, in order. `engine` is resolved against
    `device` by :func:`resolve_engine` and picks kernels or plain versions.
    """
    engine = resolve_engine(engine, device)
    col_cache: dict = {}
    units = []
    for stream, cfg in pairs:
        cols = col_cache.get(id(stream))
        if cols is None:
            cols = col_cache[id(stream)] = stream_cols(stream)
        units.append((cols, cfg))
    cycles, counts = _simulate(marshal(units, device), engine)
    return [(c, o, m, h) for c, (o, m, h) in zip(cycles.tolist(),
                                                  counts.tolist())]


def run_scheduling_loop(n_warps: int, op_start, issue, kind, blk_off,
                        blk_len, blocks, nbytes, cfg: MachineConfig,
                        device="cuda", engine: str = "auto"
                        ) -> Tuple[float, int, int, int]:
    """One stream on one machine: a one-unit family launch."""
    engine = resolve_engine(engine, device)
    cols = stream_cols(StreamCols(n_warps, op_start, issue, kind, blk_off,
                                  blk_len, blocks, nbytes))
    cycles, counts = _simulate(marshal([(cols, cfg)], device), engine)
    o, m, h = counts[0].tolist()
    return float(cycles[0]), o, m, h
