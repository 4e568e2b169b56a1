"""The paper's 15 benchmark programs (arXiv:1205.4967 Table 2), as the
study models them, with the seed-driven draws that expand them.

A plain restatement of the study's workload model, kept with the
benchmark so that no change to the program can move it: a program is a
tree of compute runs, memory instructions, loops and data-dependent
branches; branch outcomes and addresses are drawn per thread from the
workload seed in walk order.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Compute:
    n: int


@dataclasses.dataclass(frozen=True)
class Mem:
    pattern: str = "coalesced"     # coalesced | strided | random | broadcast
    is_load: bool = True
    stride: int = 4
    working_set: int = 1 << 20
    irregularity: float = 0.0      # share of accesses redrawn at random
    region: str = ""               # named region: one base for all instances
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class Branch:
    p_taken: float
    corr: float
    then: Sequence["Stmt"]
    orelse: Sequence["Stmt"] = ()


@dataclasses.dataclass(frozen=True)
class Loop:
    trips: int
    body: Sequence["Stmt"]


Stmt = Union[Compute, Mem, Branch, Loop]

C, M, B, L = Compute, Mem, Branch, Loop

PROGRAMS = {
    "BFS": [
        M(),
        B(0.45, 0.90, [
            C(8), M("random", region="bfs_edges", working_set=1 << 19),
            L(2, [M("random", region="bfs_nodes", working_set=1 << 18),
                  C(3),
                  B(0.5, 0.85,
                    [M("random", is_load=False, working_set=1 << 18), C(4)],
                    [C(1)])]),
        ], [C(1)]),
        C(2),
    ],
    "BKP": [L(6, [M(), M(working_set=1024), C(6), M("strided", stride=8),
                  C(4), M(is_load=False)])],
    "DYN": [L(8, [M("broadcast"), C(24),
                  M(region="dyn_tab", working_set=1 << 14), C(16)])],
    "FWAL": [L(7, [M(region="fwal_buf", working_set=1 << 15), C(10),
                   M(region="fwal_buf", working_set=1 << 15,
                     is_load=False)])],
    "GAS": [L(5, [M(working_set=512), M("strided", stride=16), M(), C(5),
                  M(is_load=False)])],
    "HSPT": [L(4, [M(region="hspt_grid", working_set=1 << 20,
                     irregularity=0.15),
                   M(region="hspt_grid", working_set=1 << 20,
                     irregularity=0.15, offset=-64),
                   C(14), B(0.12, 0.96, [C(3)], []), M(is_load=False)])],
    "MP": [L(6, [M("random", region="mp_tree", working_set=1 << 15), C(16),
                 B(0.5, 0.80,
                   [C(12), M("random", region="mp_tree",
                             working_set=1 << 15)],
                   [C(5), B(0.5, 0.80, [C(10)], [C(3)])])])],
    "MTM": [L(6, [M(), M("strided", stride=64), C(8)]),
            M("strided", stride=128, is_load=False),
            M("strided", stride=128, is_load=False)],
    "MU": [L(5, [M("random", region="mu_tree", working_set=1 << 15), C(16),
                 B(0.45, 0.80,
                   [C(14), M("random", region="mu_tree",
                             working_set=1 << 15)],
                   [C(5)])])],
    "NNC": [L(5, [M(irregularity=0.1), C(6), B(0.3, 0.86, [C(4)], [])])],
    "NQU": [L(8, [C(6),
                  B(0.5, 0.75, [C(10), B(0.5, 0.75, [C(8)], [C(2)])],
                    [C(2)]),
                  M("broadcast")])],
    "NW": [L(5, [M("strided", stride=8), M(working_set=1024), C(8),
                 B(0.2, 0.92, [C(3)], []), M(is_load=False)])],
    "SCN": [L(4, [B(0.55, 0.88,
                    [M("strided", region="scn_buf", stride=8), C(5),
                     M("strided", region="scn_buf", stride=8,
                       is_load=False)],
                    [C(1)])])],
    "SR1": [L(5, [M(region="sr1_img", working_set=1 << 21),
                  M(region="sr1_img", working_set=1 << 21, offset=-64),
                  M(region="sr1_img", working_set=1 << 21, offset=64),
                  M(working_set=512), C(9), M(is_load=False)])],
    "SR2": [L(4, [M(region="sr2_img", working_set=1 << 17),
                  M(region="sr2_img", working_set=1 << 17, offset=64),
                  M(working_set=512), C(9), M(is_load=False)])],
}

WORD = 4            # bytes a thread accesses
REGION_BITS = 28    # each statement region spans 256 MB of addresses


def correlated_outcomes(rng: np.random.Generator, n: int, p: float,
                        corr: float) -> np.ndarray:
    """Per-thread Bernoulli(p) outcomes, constant over runs of neighbouring
    threads whose length is geometric with mean 1 / (1 - corr)."""
    corr = min(max(corr, 0.0), 0.995)
    new_run = rng.random(n) < (1.0 - corr)
    new_run[0] = True
    run_id = np.cumsum(new_run) - 1
    draws = rng.random(int(run_id[-1]) + 1) < p
    return draws[run_id]


def addresses(stmt: Mem, uid: int, n: int,
              rng: np.random.Generator) -> np.ndarray:
    """Byte address of every thread for one dynamic memory instruction."""
    if stmt.region:
        region = zlib.crc32(stmt.region.encode()) % (1 << 20)
    else:
        region = (1 << 20) + uid
    base = np.int64(region) << REGION_BITS
    tid = np.arange(n, dtype=np.int64)
    ws = max(int(stmt.working_set), WORD * n)
    if stmt.pattern == "coalesced":
        off = tid * WORD
    elif stmt.pattern == "strided":
        off = tid * np.int64(stmt.stride)
    elif stmt.pattern == "random":
        off = rng.integers(0, ws, n, dtype=np.int64)
    elif stmt.pattern == "broadcast":
        off = np.zeros(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown pattern {stmt.pattern!r}")
    off = (off + np.int64(stmt.offset)) % ws
    if stmt.irregularity > 0.0:
        irr = rng.random(n) < stmt.irregularity
        off = np.where(irr, rng.integers(0, ws, n, dtype=np.int64), off)
    return base + off
