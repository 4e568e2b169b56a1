"""Benchmark workloads for the warp-size study.

Each of the paper's 15 benchmarks (Table 2) is modeled as a small structured
*kernel program* — a tree of compute segments, global-memory accesses and
(possibly nested) data-dependent branches — plus a statistical behavior
profile (branch-taken probability, neighbor-thread correlation, memory
access pattern mix, working-set size) calibrated to the behavior the paper
reports for that benchmark:

* BFS / MP / MU / NQU / SC(N): branch-divergence prone, small-warp friendly.
* BKP / GAS / SR1 / SR2: coalescing-hungry, large-warp friendly.
* FWAL / DYN: insensitive (little divergence, accesses already coalesced).
* MTM: uncoalesced *writes* (ideal read-coalescing cannot help — paper §7).

The program is expanded per-thread deterministically from a seed, so every
machine model sees the *same* logical workload and results are reproducible.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np

# --------------------------------------------------------------------------
# Program IR
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Compute:
    """`n` back-to-back ALU instructions."""

    n: int


@dataclasses.dataclass(frozen=True)
class Mem:
    """One global-memory instruction executed by every active thread.

    pattern:
      'coalesced'  addr = base + tid*4            (unit stride, 32-bit words)
      'strided'    addr = base + tid*stride
      'random'     addr = base + U(0, working_set)
      'broadcast'  addr = base                    (all threads same word)
    """

    pattern: str = "coalesced"
    is_load: bool = True
    stride: int = 4
    working_set: int = 1 << 20
    # Fraction of accesses that fall back to 'random' (irregular tail).
    irregularity: float = 0.0
    # Named address region: statements sharing a region share one base
    # address across all dynamic instances (temporal reuse + inter-warp
    # sharing, e.g. stencil halos). None = fresh region per instance.
    region: Optional[str] = None
    # Byte offset added to every address (stencil shifts).
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class Branch:
    """Data-dependent branch: `then` / `orelse` bodies, then reconvergence.

    p_taken: marginal probability a thread takes the `then` side.
    corr:    neighbor-thread correlation in [0, 1]; 1.0 = whole block agrees
             (never diverges), 0.0 = i.i.d. per thread (max divergence).
    """

    p_taken: float
    corr: float
    then: Sequence["Stmt"]
    orelse: Sequence["Stmt"] = ()


@dataclasses.dataclass(frozen=True)
class Loop:
    """Uniform-trip-count loop (all threads iterate together)."""

    trips: int
    body: Sequence["Stmt"]


Stmt = Union[Compute, Mem, Branch, Loop]


# --------------------------------------------------------------------------
# Thread-level trace (expansion phase 1)
# --------------------------------------------------------------------------

# ThreadTrace event kinds. COMPUTE/LOAD/STORE deliberately share the values
# of divergence.KIND_* so aggregation can emit op kinds without remapping;
# SPLIT/RESET are MIMD fragment-bookkeeping events that SIMT aggregation
# skips.
TEV_COMPUTE = 0
TEV_LOAD = 1
TEV_STORE = 2
TEV_SPLIT = 3
TEV_RESET = 4


#: The ThreadTrace array fields, as a snapshot stores them (``.npz``, one
#: array per field: the reference's layout, so either package reads a
#: snapshot the other wrote).
TRACE_FIELDS = ("ev_kind", "ev_mask", "ev_arg", "ev_addr", "masks",
                "addr_off", "addr_vals")


@dataclasses.dataclass
class ThreadTrace:
    """Expansion-key-independent thread-level trace of one workload.

    Phase 1 of the two-phase workload expansion
    (:func:`~repro_torch.core.warpsim.divergence.build_thread_trace`):
    everything ``expand_stream`` draws from the workload seed — branch outcomes (as
    active-thread masks), memory addresses, the walk order of statement
    instances — recorded once per ``(bench, n_threads, seed)`` as a linear
    *event tape* over a table of unique thread masks. Per-warp aggregation
    (phase 2) replays the tape for any ``MachineConfig.expansion_key()``
    without touching the rng, so every expansion key of one workload shares
    this object (and it can be persisted: all content is deterministic in
    the seed and process-stable region hashing).

    Events reference rows of ``masks``; memory events additionally
    reference a row of the CSR address pool (``addr_off``/``addr_vals``),
    which stores the byte addresses of the *active* threads of the event's
    mask in ascending thread order.
    """

    n_threads: int
    ev_kind: np.ndarray    # int8[n_ev]   TEV_*
    ev_mask: np.ndarray    # int32[n_ev]  row of `masks`
    ev_arg: np.ndarray     # int64[n_ev]  compute count / then-mask row (SPLIT)
    ev_addr: np.ndarray    # int64[n_ev]  address row of mem events, else -1
    masks: np.ndarray      # bool[n_masks, n_threads]
    addr_off: np.ndarray   # int64[n_addr_rows+1] CSR offsets
    addr_vals: np.ndarray  # int64[total_active] active-thread byte addresses

    @property
    def n_events(self) -> int:
        return len(self.ev_kind)

    @property
    def n_masks(self) -> int:
        return len(self.masks)

    def tid_csr(self):
        """Active thread ids per mask as CSR ``(tid_off, tid_cat)``.

        ``tid_cat[tid_off[m]:tid_off[m+1]]`` are the ascending thread ids
        of mask row ``m`` — the expansion-key-independent half of the
        per-mask statistics every aggregation pass needs. Computed once and
        cached on the trace (shared by every expansion key).
        """
        cached = getattr(self, "_tid_csr", None)
        if cached is None:
            rows, cols = np.nonzero(self.masks)
            off = np.zeros(self.n_masks + 1, dtype=np.int64)
            np.cumsum(np.bincount(rows, minlength=self.n_masks), out=off[1:])
            cached = (off, cols.astype(np.int64, copy=False))
            self._tid_csr = cached
        return cached


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    program: Sequence[Stmt]
    n_threads: int = 2048           # per simulated SM pool (scaled)
    seed: int = 0
    # Relative weight used when averaging across the suite (all equal).
    description: str = ""


# --------------------------------------------------------------------------
# Correlated branch outcomes
# --------------------------------------------------------------------------


def correlated_outcomes(
    rng: np.random.Generator, n: int, p: float, corr: float
) -> np.ndarray:
    """Per-thread Bernoulli(p) outcomes with neighbor-run correlation.

    Outcomes are constant over *runs* of neighboring threads whose length is
    geometric with mean ``L = 1/(1-corr)`` (corr=0 -> i.i.d. threads,
    corr→1 -> long uniform runs). A warp of size W is divergence-free iff it
    is covered by a single run, so the probability of divergence grows with
    W at a rate set by `corr` — exactly the sub-warp-granularity structure
    that makes small warps diverge less than large ones (paper §1).
    """
    corr = min(max(corr, 0.0), 0.995)
    # Each thread starts a new run with probability (1-corr).
    new_run = rng.random(n) < (1.0 - corr)
    new_run[0] = True
    run_id = np.cumsum(new_run) - 1
    draws = rng.random(int(run_id[-1]) + 1) < p
    return draws[run_id]


# --------------------------------------------------------------------------
# The 15 paper benchmarks (Table 2), scaled
# --------------------------------------------------------------------------


def _bfs() -> Workload:
    # Graph traversal: heavy divergence (frontier checks), random neighbor
    # loads, light compute. Paper: small warps win big.
    prog = [
        Mem("coalesced"),                       # read frontier flag
        Branch(
            p_taken=0.45, corr=0.90,
            then=[
                Compute(8),
                Mem("random", region="bfs_edges", working_set=1 << 19),
                Loop(2, [
                    Mem("random", region="bfs_nodes", working_set=1 << 18),
                    Compute(3),
                    Branch(p_taken=0.5, corr=0.85,
                           then=[Mem("random", is_load=False,
                                     working_set=1 << 18), Compute(4)],
                           orelse=[Compute(1)]),
                ]),
            ],
            orelse=[Compute(1)],
        ),
        Compute(2),
    ]
    return Workload("BFS", prog, description="graph breadth-first search")


def _bkp() -> Workload:
    # Back propagation: dense layered updates, perfectly strided accesses,
    # almost no divergence. Paper: coalescing-bound — large warps win,
    # WS8 is the worst machine.
    prog = [
        Loop(6, [
            Mem("coalesced"),
            Mem("coalesced", working_set=1024),  # weight tile: shared
            Compute(6),
            Mem("strided", stride=8),
            Compute(4),
            Mem("coalesced", is_load=False),
        ]),
    ]
    return Workload("BKP", prog, description="back propagation")


def _dyn() -> Workload:
    # Dynamic programming: compute-heavy, cached small working set —
    # insensitive to warp size (paper §7).
    prog = [
        Loop(8, [
            Mem("broadcast"),
            Compute(24),
            Mem("coalesced", region="dyn_tab", working_set=1 << 14),
            Compute(16),
        ]),
    ]
    return Workload("DYN", prog, description="dynamic programming (insensitive)")


def _fwal() -> Workload:
    # Fast Walsh transform: butterfly strides hit cache, uniform control —
    # insensitive.
    prog = [
        Loop(7, [
            Mem("coalesced", region="fwal_buf", working_set=1 << 15),
            Compute(10),
            Mem("coalesced", region="fwal_buf", working_set=1 << 15,
                is_load=False),
        ]),
    ]
    return Workload("FWAL", prog, description="fast Walsh transform (insensitive)")


def _gas() -> Workload:
    # Gaussian elimination: row-strided loads, low divergence —
    # coalescing-hungry.
    prog = [
        Loop(5, [
            Mem("coalesced", working_set=512),   # pivot row: shared by all
            Mem("strided", stride=16),
            Mem("coalesced"),
            Compute(5),
            Mem("coalesced", is_load=False),
        ]),
    ]
    return Workload("GAS", prog, description="gaussian elimination")


def _hspt() -> Workload:
    # Hotspot stencil: mostly coalesced with halo irregularity, mild
    # divergence at borders.
    prog = [
        Loop(4, [
            Mem("coalesced", region="hspt_grid", working_set=1 << 20,
                irregularity=0.15),
            Mem("coalesced", region="hspt_grid", working_set=1 << 20,
                irregularity=0.15, offset=-64),
            Compute(14),
            Branch(p_taken=0.12, corr=0.96, then=[Compute(3)], orelse=[]),
            Mem("coalesced", is_load=False),
        ]),
    ]
    return Workload("HSPT", prog, description="hotspot stencil")


def _mp() -> Workload:
    # MUMmerGPU++: suffix-tree walk — extreme divergence, pointer chasing,
    # compute-bound (memory NOT under pressure; paper §6.1).
    prog = [
        Loop(6, [
            Mem("random", region="mp_tree", working_set=1 << 15),
            Compute(16),
            Branch(p_taken=0.5, corr=0.80,
                   then=[Compute(12),
                         Mem("random", region="mp_tree", working_set=1 << 15)],
                   orelse=[Compute(5),
                           Branch(p_taken=0.5, corr=0.80,
                                  then=[Compute(10)], orelse=[Compute(3)])]),
        ]),
    ]
    return Workload("MP", prog, n_threads=1024, description="MUMmerGPU++")


def _mtm() -> Workload:
    # Matrix multiply (SDK): coalesced reads, but column-major *writes*
    # uncoalesced — the one case where SW+'s read-only ideal coalescing
    # does not cover the damage (paper §7).
    prog = [
        Loop(6, [
            Mem("coalesced"),
            Mem("strided", stride=64),            # B-matrix column walk
            Compute(8),
        ]),
        Mem("strided", stride=128, is_load=False),  # uncoalesced writes
        Mem("strided", stride=128, is_load=False),
    ]
    return Workload("MTM", prog, description="matrix multiply")


def _mu() -> Workload:
    # MUMmerGPU: like MP — divergence-dominated, compute-bound.
    prog = [
        Loop(5, [
            Mem("random", region="mu_tree", working_set=1 << 15),
            Compute(16),
            Branch(p_taken=0.45, corr=0.80,
                   then=[Compute(14),
                         Mem("random", region="mu_tree", working_set=1 << 15)],
                   orelse=[Compute(5)]),
        ]),
    ]
    return Workload("MU", prog, n_threads=1024, description="MUMmerGPU")


def _nnc() -> Workload:
    # Nearest neighbor: streaming loads with divergent distance updates.
    prog = [
        Loop(5, [
            Mem("coalesced", irregularity=0.1),
            Compute(6),
            Branch(p_taken=0.3, corr=0.86, then=[Compute(4)], orelse=[]),
        ]),
    ]
    return Workload("NNC", prog, description="nearest neighbor")


def _nqu() -> Workload:
    # N-Queens backtracking: worst-case control divergence, tiny memory
    # footprint — compute/divergence bound.
    prog = [
        Loop(8, [
            Compute(6),
            Branch(p_taken=0.5, corr=0.75,
                   then=[Compute(10),
                         Branch(p_taken=0.5, corr=0.75,
                                then=[Compute(8)], orelse=[Compute(2)])],
                   orelse=[Compute(2)]),
            Mem("broadcast"),
        ]),
    ]
    return Workload("NQU", prog, n_threads=1024, description="n-queens")


def _nw() -> Workload:
    # Needleman-Wunsch: wavefront with strided accesses and mild divergence.
    prog = [
        Loop(5, [
            Mem("strided", stride=8),
            Mem("coalesced", working_set=1024),  # substitution matrix
            Compute(8),
            Branch(p_taken=0.2, corr=0.92, then=[Compute(3)], orelse=[]),
            Mem("coalesced", is_load=False),
        ]),
    ]
    return Workload("NW", prog, description="needleman-wunsch")


def _sc() -> Workload:
    # Scan: log-step tree — active-thread set halves each step (classic
    # divergence), strided accesses.
    prog = [
        Loop(4, [
            Branch(p_taken=0.55, corr=0.88,
                   then=[Mem("strided", region="scn_buf", stride=8), Compute(5),
                         Mem("strided", region="scn_buf", stride=8, is_load=False)],
                   orelse=[Compute(1)]),
        ]),
    ]
    return Workload("SCN", prog, description="parallel scan")


def _sr1() -> Workload:
    # SRAD large: image stencil, fully coalesced, memory-intensive.
    prog = [
        Loop(5, [
            Mem("coalesced", region="sr1_img", working_set=1 << 21),
            Mem("coalesced", region="sr1_img", working_set=1 << 21, offset=-64),
            Mem("coalesced", region="sr1_img", working_set=1 << 21, offset=64),
            Mem("coalesced", working_set=512),   # diffusion coefficients
            Compute(9),
            Mem("coalesced", is_load=False),
        ]),
    ]
    return Workload("SR1", prog, description="SRAD (large)")


def _sr2() -> Workload:
    # SRAD small: same kernel, smaller working set (more cache reuse).
    prog = [
        Loop(4, [
            Mem("coalesced", region="sr2_img", working_set=1 << 17),
            Mem("coalesced", region="sr2_img", working_set=1 << 17, offset=64),
            Mem("coalesced", working_set=512),   # diffusion coefficients
            Compute(9),
            Mem("coalesced", is_load=False),
        ]),
    ]
    return Workload("SR2", prog, description="SRAD (small)")


_FACTORIES = {
    "BFS": _bfs, "BKP": _bkp, "DYN": _dyn, "FWAL": _fwal, "GAS": _gas,
    "HSPT": _hspt, "MP": _mp, "MTM": _mtm, "MU": _mu, "NNC": _nnc,
    "NQU": _nqu, "NW": _nw, "SCN": _sc, "SR1": _sr1, "SR2": _sr2,
}

BENCHMARKS = tuple(_FACTORIES)

# Paper-reported behavior classes (Section 7), used in validation tests.
DIVERGENT = ("BFS", "MP", "MU", "NQU", "SCN")
COALESCING_HUNGRY = ("BKP", "GAS", "SR1", "SR2")
INSENSITIVE = ("FWAL", "DYN")


@functools.lru_cache(maxsize=256)
def _workload(name: str, n_threads: Optional[int], seed: int) -> Workload:
    wl = _FACTORIES[name]()
    if n_threads is not None or seed != wl.seed:
        wl = dataclasses.replace(
            wl, n_threads=n_threads or wl.n_threads, seed=seed)
    return wl


def get_workload(name: str, n_threads: Optional[int] = None,
                 seed: int = 0) -> Workload:
    """Benchmark workload by name (memoized; workloads are read-only)."""
    try:
        return _workload(name.upper(), n_threads, seed)
    except KeyError:
        raise KeyError(f"unknown benchmark {name!r}; have {BENCHMARKS}") from None


def program_stats(program: Sequence[Stmt]) -> dict:
    """Static instruction mix of a program (single thread, expected path)."""
    n_compute = n_mem = n_branch = 0

    def walk(stmts, weight=1.0):
        nonlocal n_compute, n_mem, n_branch
        for s in stmts:
            if isinstance(s, Compute):
                n_compute += weight * s.n
            elif isinstance(s, Mem):
                n_mem += weight
            elif isinstance(s, Loop):
                walk(s.body, weight * s.trips)
            elif isinstance(s, Branch):
                n_branch += weight
                walk(s.then, weight * s.p_taken)
                walk(s.orelse, weight * (1 - s.p_taken))

    walk(program)
    return {"compute": n_compute, "mem": n_mem, "branch": n_branch}
