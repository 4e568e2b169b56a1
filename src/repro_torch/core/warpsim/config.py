"""Machine configuration for the SIMT warp-size timing model.

Mirrors Table 1 of the paper (GPGPU-sim 2.1.1b baseline): 16 SMs, 8-wide
SIMD, 24-stage pipeline, 1024 thread contexts per SM, 64 B cache blocks /
memory-transaction strides, 6 memory controllers at 76.8 GB/s aggregate.

The simulator scales the SM count down (SMs are homogeneous and the paper's
benchmarks fill them symmetrically); DRAM bandwidth is scaled with it so
per-SM memory pressure is preserved.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """A warp-size machine point (baseline, SW+ or LW+)."""

    name: str = "ws32"
    warp_size: int = 32
    simd_width: int = 8

    # --- idealizations (Section 4 of the paper) ---
    # SW+: ideal coalescing — read requests merge with any outstanding
    # request to the same 64 B block across *all* threads of the SM.
    ideal_coalescing: bool = False
    # LW+: MIMD engine — branch divergence costs nothing (paths run
    # concurrently), but the warp still synchronizes at every instruction.
    mimd: bool = False

    # --- core ---
    num_sms: int = 2                  # scaled from 16 (homogeneous SMs)
    threads_per_sm: int = 1024
    pipeline_depth: int = 24          # cycles before a warp's next dependent issue
    core_clock_ghz: float = 1.3

    # --- memory system ---
    num_mem_ctrls: int = 6
    # 76.8 GB/s aggregate for 16 SMs -> keep per-SM share constant when
    # scaling num_sms down: bw * (num_sms / 16).
    dram_bw_gbps: float = 76.8
    dram_latency_cycles: int = 420    # row activate + queue + bus + crossbar
    transaction_bytes: int = 64       # stride / cache-block size (Table 1)

    # --- L1 data cache (48 KB, 8-way, LRU, 64 B blocks) ---
    l1_size_bytes: int = 48 * 1024
    l1_ways: int = 8
    l1_hit_latency: int = 1

    def __post_init__(self) -> None:
        if self.warp_size % self.simd_width and self.warp_size > self.simd_width:
            raise ValueError(
                f"warp_size {self.warp_size} must be a multiple of simd_width "
                f"{self.simd_width} (or smaller than it)"
            )
        if self.threads_per_sm % self.warp_size:
            raise ValueError("threads_per_sm must be a multiple of warp_size")

    @property
    def warps_per_sm(self) -> int:
        return self.threads_per_sm // self.warp_size

    def expansion_key(self) -> tuple:
        """The machine parameters that determine ``expand_stream`` output.

        Workload expansion (divergence model, intra-warp coalescing, issue
        occupancy) reads exactly these four fields; every other field only
        affects the *timing* of the expanded stream. Machines that share an
        expansion key therefore share one :class:`WarpStream` per workload
        — the sweep engine groups grid cells by this key and expands once
        per group (``tests/test_golden.py`` locks the equivalence).
        """
        return (self.warp_size, self.simd_width, self.mimd,
                self.transaction_bytes)

    @property
    def issue_cycles_per_group(self) -> int:
        """Cycles to push one active path of a warp through the front-end."""
        return max(1, self.warp_size // self.simd_width)

    @property
    def dram_cycles_per_transaction(self) -> float:
        """Core cycles of DRAM-bus occupancy per 64 B transaction, per ctrl.

        Bandwidth is scaled so each simulated SM sees the same share of the
        76.8 GB/s the paper's 16 SMs share.
        """
        bw = self.dram_bw_gbps * (self.num_sms / 16.0)
        per_ctrl_bytes_per_sec = bw * 1e9 / self.num_mem_ctrls
        secs = self.transaction_bytes / per_ctrl_bytes_per_sec
        return secs * self.core_clock_ghz * 1e9

    @property
    def l1_sets(self) -> int:
        return self.l1_size_bytes // (self.transaction_bytes * self.l1_ways)
