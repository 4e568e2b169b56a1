"""The trace-family launch on the card: K2, with K1 folded in, in CUDA C++.

Counterpart of the reference's Pallas device program. One launch of
``ws_family_kernel`` simulates a whole *trace family*: every (expansion key
x machine variant) unit derived from one ThreadTrace. The host marshals
each unit's :class:`WarpStream` columns plus the machine's scalars into
concatenated tensors (:func:`marshal`), and the kernel (K2) runs the
scheduling recurrence, one warp per unit, and returns ``(raw_cycles,
offchip, merged, l1_hits)`` per unit. As its lanes stage an op's blocks
they prep them (K1: memory controller, L1 set, store occupancy), so the
study launches nothing else. K2 has two placements of the units' state,
picked per launch by :func:`placement`: ``"shared"`` (each unit's state in
its block's shared memory) when the largest unit's state fits
:data:`SMEM_LIMIT`, else ``"global"`` (every unit's state in global
scratch).

``ws_prep_kernel`` runs K1's code alone over every block (:func:`prep`):
the entry that holds it against :func:`prep_ref` on the card, off the
study's path. Both kernels live in ``csrc/warpsim_family.cu`` over the
``__host__ __device__`` code of ``csrc/warpsim_family.cuh``. They are
built with ``nvcc`` at first use into ``<repo>/build/repro_torch/``
(keyed by a hash of the sources and flags) and bound through ctypes.
Beside each kernel sits its plain PyTorch version (:func:`prep_ref`,
:func:`simulate_family_ref`); a wrapper takes the plain version only for
tensors on the CPU. On a CUDA tensor it launches the kernel or raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _nvcc as nvcc_build
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.timing import HOST_ENGINES

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = nvcc_build.BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
_SOURCES = ("warpsim_family.cu", "warpsim_family.cuh")

# Column names of the per-unit parameter tables, in the order of the
# WS_* enums in csrc/warpsim_family.cuh.
UP_COLS = ("warp_off", "op_off", "blk_off", "n_warps", "n_blocks", "n_sms",
           "nctrl", "n_sets", "ways", "ideal", "n_slots", "small_off",
           "big_off", "ctrl_mul", "ctrl_shift", "sets_mul", "sets_shift")
FP_COLS = ("hit_lat", "depth", "dram_lat", "svc_unit")
_UP = {name: i for i, name in enumerate(UP_COLS)}
_FP = {name: i for i, name in enumerate(FP_COLS)}

KERNELS = ("ws_prep_kernel", "ws_family_kernel")
#: Where K2 keeps the units' state: the routes of ``ws_family_kernel``.
PLACEMENTS = ("shared", "global")
#: Dynamic shared memory one block of K2 may use on an H100: the 227 KB a
#: block may have, less 1 KB kept for K2's static stage of 32 blocks'
#: columns (768 bytes).
SMEM_LIMIT = 232448 - 1024

# Launches per kernel, counted by the wrappers where they launch, and K2's
# launches per placement. The sweep service launches from several threads
# at once, so every update takes the lock.
_COUNT_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}  # guarded-by: _COUNT_LOCK
_ROUTE_LAUNCHES: Dict[Tuple[str, str], int] = {}  # guarded-by: _COUNT_LOCK
# The library, loaded once: the first of several threads builds and binds
# it while the others wait.
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[str] = None
_TORCH_DTYPE = {np.dtype(np.int64).str: torch.int64,
                np.dtype(np.int8).str: torch.int8,
                np.dtype(np.float64).str: torch.float64}


def launch_count(kernel: str) -> int:
    """Launches of `kernel` (one of :data:`KERNELS`) since the last reset."""
    with _COUNT_LOCK:
        return _LAUNCHES[kernel]


def route_count(kernel: str, route: str) -> int:
    """Launches of `kernel` by `route` (K2's placements,
    :data:`PLACEMENTS`) since the last reset."""
    with _COUNT_LOCK:
        return _ROUTE_LAUNCHES.get((kernel, route), 0)


def count_launch(kernel: str, route: Optional[str] = None) -> None:
    """Count one launch of `kernel` (by `route`, when it has routes); the
    wrappers call it where they launch, and nowhere else."""
    with _COUNT_LOCK:
        _LAUNCHES[kernel] += 1
        if route is not None:
            key = (kernel, route)
            _ROUTE_LAUNCHES[key] = _ROUTE_LAUNCHES.get(key, 0) + 1


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            _LAUNCHES[name] = 0
        _ROUTE_LAUNCHES.clear()


def status() -> dict:
    """Whether a card is visible, which library is loaded, launch counts."""
    with _COUNT_LOCK:
        launches = dict(_LAUNCHES)
    return {
        "cuda_available": torch.cuda.is_available(),
        "library": _LIB_PATH,
        "launches": launches,
    }


#: Every engine name a caller may give (``timing.HOST_ENGINES`` and the
#: family engines, ``"auto"`` first).
ENGINES = ("auto", "cuda", "torch") + HOST_ENGINES


def resolve_engine(engine: str, device) -> str:
    """``"cuda"`` (the kernels) on a CUDA device, ``"torch"`` (the plain
    versions) on the CPU; ``"auto"`` resolves from `device`, and a family
    engine that does not match the device raises. The host engines
    (``timing.HOST_ENGINES``) run on the host CPU whatever the device, and
    come back as they are."""
    dev = torch.device(device)
    want = {"cuda": "cuda", "cpu": "torch"}.get(dev.type)
    if want is None:
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    if engine == "auto":
        return want
    if engine in HOST_ENGINES:
        return engine
    if engine not in ENGINES:
        hint = (" (the reference's device engine: the port's is 'cuda', "
                "on a CUDA device)" if engine == "pallas" else "")
        raise ValueError(f"unknown engine {engine!r}{hint}; use "
                         f"{'|'.join(ENGINES)}")
    if engine != want:
        raise ValueError(f"engine {engine!r} does not run on device {dev}")
    return engine


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


_nvcc = nvcc_build.find_nvcc


def build() -> str:
    """Build the kernel library (once per source hash); returns its path.

    Raises RuntimeError with nvcc's output when the build fails.
    """
    return nvcc_build.build_shared(CSRC / _SOURCES[0],
                                   [CSRC / n for n in _SOURCES[1:]],
                                   NVCC_FLAGS, BUILD_DIR, _nvcc)


def load() -> str:
    """Build (when needed) and load the kernel library; returns its path.
    Raises RuntimeError with nvcc's output when the build fails."""
    _lib()
    return _LIB_PATH


def _lib() -> ctypes.CDLL:
    global _LIB, _LIB_PATH
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        path = build()
        lib = ctypes.CDLL(path)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ws_prep_launch.argtypes = [ptr] * 7 + [i64, i64, ptr]
        lib.ws_prep_launch.restype = ctypes.c_int
        lib.ws_family_launch.argtypes = [ptr] * 14 + [i64, i64, ptr]
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


def divisor_constants(d: int) -> Tuple[int, int]:
    """``(m, l)`` for ``ws_mod`` in ``csrc/warpsim_family.cuh``: ``l =
    ceil(log2 d)``, ``m = ceil(2**(63 + l) / d)``, so that ``b % d`` is
    ``b - ((2 b * m) >> (64 + l)) * d`` for every ``0 <= b < 2**63``.
    ``m`` is returned as the int64 of its 64 bits (``m < 2**64``)."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} outside [1, 2**31)")
    l = (d - 1).bit_length()
    m = (2 ** (63 + l) + d - 1) // d
    return (m - 2 ** 64 if m >= 2 ** 63 else m), l


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
    scratch_len: int        # 8-byte words of global scratch for every unit's state
    state_bytes: int        # bytes of the largest unit's state
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
    warp_off = op_off = blk_off = scratch = state = 0
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
        # K2 indexes within a unit in int32 and keeps tags (slot ids) and
        # LRU ticks (up to two a block) in int32.
        if max(nw, n_ops, 2 * n_blk, m["n_sms"] * n_slots, lines,
               m["nctrl"]) >= 2 ** 31:
            raise ValueError(f"unit {u} is too large for one family launch: "
                             f"{nw} warps, {n_ops} ops, {n_blk} blocks, "
                             f"{n_slots} slots, {lines} L1 lines")
        # State sizes, in 8-byte words, in the layout ws_simulate_unit
        # carves them: the small part (warps, SMs, controllers) padded to
        # an even count, then the big one (L1 lines, SW+ table).
        small = 5 * nw + m["n_sms"] + m["nctrl"] + (m["n_sms"] + 1) // 2
        small += small % 2
        big = 2 * lines + (m["n_sms"] * n_slots if m["ideal"] else 0)
        (ctrl_mul, ctrl_shift), (sets_mul, sets_shift) = (
            divisor_constants(m["nctrl"]), divisor_constants(m["n_sets"]))
        row = dict(warp_off=warp_off, op_off=op_off, blk_off=blk_off,
                   n_warps=nw, n_blocks=n_blk, n_slots=n_slots,
                   small_off=scratch, big_off=scratch + small,
                   ctrl_mul=ctrl_mul, ctrl_shift=ctrl_shift,
                   sets_mul=sets_mul, sets_shift=sets_shift,
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
        scratch += small + big + big % 2  # keeps every part 16-byte aligned
        state = max(state, 8 * (small + big))

    if dev.type == "cuda":
        # Each column is concatenated straight into pinned host memory and
        # copied with non_blocking=True: a blocking copy synchronizes the
        # stream, holding the host until the family still running on it
        # has finished. The caching host allocator reuses a pinned block
        # only once the copies recorded on it have run.
        def t(parts: List[np.ndarray]) -> torch.Tensor:
            host = torch.empty(sum(len(a) for a in parts),
                               dtype=_TORCH_DTYPE[parts[0].dtype.str],
                               pin_memory=True)
            np.concatenate(parts, out=host.numpy())
            return host.to(dev, non_blocking=True)
    else:
        def t(parts: List[np.ndarray]) -> torch.Tensor:
            return torch.from_numpy(np.concatenate(parts))

    return Family(
        up=t([up.reshape(-1)]).view(up.shape),
        fp=t([fp.reshape(-1)]).view(fp.shape),
        **{k: t(v) for k, v in cols.items()},
        scratch_len=scratch, state_bytes=state,
        max_blocks=int(up[:, _UP["n_blocks"]].max()))


# ---------------------------------------------------------------------------
# K1: block prep
# ---------------------------------------------------------------------------


def prep(fam: Family) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per block of every unit: ``(ctrl, si, ssvc)``. Launches K1 alone
    (``ws_prep_kernel``) on a CUDA family; runs :func:`prep_ref` on a CPU
    one.

    Not on the study's path: K2 runs the same code (``ws_prep_block``) on
    the blocks it stages. This is the entry that holds that code against
    :func:`prep_ref` on the card."""
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
    count_launch("ws_prep_kernel")
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


def placement(fam: Family) -> str:
    """Where K2 keeps `fam`'s state: ``"shared"`` when the largest unit's
    state fits one block's shared memory (:data:`SMEM_LIMIT`), else
    ``"global"``. Both placements are one kernel and give the same bits;
    the shared one is faster."""
    return "shared" if fam.state_bytes <= SMEM_LIMIT else "global"


def simulate_family(fam: Family, where: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(raw_cycles float64[U], counts int64[U, 3])`` with counts
    ``(offchip, merged, l1_hits)``. Launches K2, which preps the blocks
    itself, once on a CUDA family, in the placement :func:`placement` picks
    (`where`, when given, names another that the state fits, as the tests
    do to hold each against the plain version); runs :func:`prep_ref` then
    :func:`simulate_family_ref` on a CPU one."""
    if fam.device.type == "cpu":
        return simulate_family_ref(
            fam, *prep_ref(fam.up, fam.fp, fam.blocks, fam.nbytes))
    _check_family(fam)
    dev = fam.device
    if where is None:
        where = placement(fam)
    if where not in PLACEMENTS:
        raise ValueError(f"unknown placement {where!r}; use {PLACEMENTS}")
    smem = fam.state_bytes if where == "shared" else 0
    if smem > SMEM_LIMIT:
        raise ValueError(f"placement {where!r} needs {smem} bytes of shared "
                         f"memory a block; at most {SMEM_LIMIT}")
    scratch = torch.empty(1 if where == "shared" else max(fam.scratch_len, 1),
                          dtype=torch.int64, device=dev)
    cycles = torch.empty(fam.n_units, dtype=torch.float64, device=dev)
    counts = torch.empty((fam.n_units, 3), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.ws_family_launch(
            fam.up.data_ptr(), fam.fp.data_ptr(), fam.next0.data_ptr(),
            fam.end.data_ptr(), fam.issue.data_ptr(), fam.kind.data_ptr(),
            fam.blk_off.data_ptr(), fam.blk_len.data_ptr(),
            fam.blocks.data_ptr(), fam.nbytes.data_ptr(),
            fam.slot.data_ptr(), scratch.data_ptr(), cycles.data_ptr(),
            counts.data_ptr(), fam.n_units, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, "ws_family_kernel", code)
    count_launch("ws_family_kernel", where)
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
         *_offsets_and_divisors) = p
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
                  device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


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


@dataclasses.dataclass
class K2Timing:
    """The timing events around one K2 launch, read by :func:`collect`
    once the launch's results are in, into the ambient domain's K2
    families (:func:`k2_metrics`)."""

    start: "torch.cuda.Event"
    end: "torch.cuda.Event"
    placement: str
    steps: int              # warp-ops of the launch's longest unit


@dataclasses.dataclass
class Launch:
    """A family launched by :func:`launch_family`, read by :func:`collect`.

    On a card, `cycles`/`counts` are pinned host tensors that a
    non-blocking copy fills behind the launch, and `done` is the event
    recorded after that copy. `inputs` keeps the marshalled family's
    device tensors, which the kernel reads, alive until the launch is read.
    `family` is the family's id for the stages' spans (``bench/n_threads/
    seed``, when the caller gave it); `k2` holds K2's timing events (on a
    card, with observability on).
    """

    cycles: torch.Tensor    # float64[U]
    counts: torch.Tensor    # int64[U, 3]
    done: Optional["torch.cuda.Event"]
    inputs: Optional[Family]
    family: Optional[str] = None
    k2: Optional[K2Timing] = None


def k2_metrics(ob: obs_mod.Observability
               ) -> Tuple[obs_mod.Histogram, obs_mod.Counter]:
    """`ob`'s ``warpsim_k2_seconds{placement}`` histogram and
    ``warpsim_k2_steps_total{placement}`` counter, made at the first
    call."""
    reg = ob.registry
    return (reg.histogram("warpsim_k2_seconds",
                          "Device seconds of one K2 launch (timing events "
                          "around it), by placement of the units' state",
                          labelnames=("placement",)),
            reg.counter("warpsim_k2_steps_total",
                        "Steps of the K2 launches (each launch's longest "
                        "unit's warp-ops), by placement",
                        labelnames=("placement",)))


def launch_family(pairs, device="cuda", engine: str = "auto",
                  family: Optional[str] = None) -> Launch:
    """Marshal a trace family and launch it, in ONE kernel launch, without
    waiting for the card.

    ``pairs`` is ``[(WarpStream, MachineConfig), ...]`` — every expansion
    key x machine variant of one ThreadTrace (streams may repeat across
    variants that share an expansion). `engine` must match `device`
    (:func:`resolve_engine`): the kernel on a card, the plain versions on
    the CPU (which finish before this returns). `family` names the family
    in the ``marshal`` and ``launch`` stages' spans.

    On a card, with observability on, a pair of timing events brackets
    K2 on the stream; :func:`collect` reads them. On a stream that other
    threads launch on at once (the service's), a launch's time may hold
    another thread's work queued between its events.
    """
    resolve_engine(engine, device)
    col_cache: dict = {}
    units = []
    for stream, cfg in pairs:
        cols = col_cache.get(id(stream))
        if cols is None:
            cols = col_cache[id(stream)] = stream_cols(stream)
        units.append((cols, cfg))
    with obs_mod.stage("marshal", family=family, units=len(units)):
        fam = marshal(units, device)
    with obs_mod.stage("launch", family=family, units=len(units)):
        if fam.device.type == "cpu":
            cycles, counts = simulate_family(fam)
            return Launch(cycles, counts, None, None, family)
        k2 = None
        stream = torch.cuda.current_stream(fam.device)
        if obs_mod.enabled():
            k2 = K2Timing(torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True),
                          placement(fam),
                          max(len(cols.issue) for cols, _cfg in units))
            k2.start.record(stream)
        cycles, counts = simulate_family(fam)
        if k2 is not None:
            k2.end.record(stream)
        host_c = torch.empty(cycles.shape, dtype=cycles.dtype,
                             pin_memory=True)
        host_n = torch.empty(counts.shape, dtype=counts.dtype,
                             pin_memory=True)
        host_c.copy_(cycles, non_blocking=True)
        host_n.copy_(counts, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        return Launch(host_c, host_n, done, fam, family, k2)


def collect(launch: Launch) -> List[Tuple[float, int, int, int]]:
    """Wait for a launch and return ``(raw_cycles, offchip, merged,
    l1_hits)`` per pair, in order. K2's timing events, recorded before the
    awaited one, are read after the wait, which they add nothing to."""
    with obs_mod.stage("wait", family=launch.family,
                       units=len(launch.cycles)):
        if launch.done is not None:
            launch.done.synchronize()
    k2 = launch.k2
    if k2 is not None:
        seconds, steps = k2_metrics(obs_mod.current_obs())
        seconds.labels(placement=k2.placement).observe(
            1e-3 * k2.start.elapsed_time(k2.end))
        steps.labels(placement=k2.placement).inc(k2.steps)
    return [(c, o, m, h) for c, (o, m, h) in zip(launch.cycles.tolist(),
                                                  launch.counts.tolist())]


def run_family(pairs, device="cuda", engine: str = "auto"
               ) -> List[Tuple[float, int, int, int]]:
    """Simulate a trace family in ONE kernel launch and wait for it:
    :func:`collect` of :func:`launch_family`."""
    return collect(launch_family(pairs, device, engine))


def run_scheduling_loop(n_warps: int, op_start, issue, kind, blk_off,
                        blk_len, blocks, nbytes, cfg: MachineConfig,
                        device="cuda", engine: str = "auto"
                        ) -> Tuple[float, int, int, int]:
    """One stream on one machine: a one-unit family launch."""
    resolve_engine(engine, device)
    cols = stream_cols(StreamCols(n_warps, op_start, issue, kind, blk_off,
                                  blk_len, blocks, nbytes))
    cycles, counts = simulate_family(marshal([(cols, cfg)], device))
    o, m, h = counts[0].tolist()
    return float(cycles[0]), o, m, h
