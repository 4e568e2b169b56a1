"""SM / DRAM timing model: result assembly and the single-cell entry point.

Scheduling model (paper §2): each SM has one scheduler issuing ready warps
back-to-back into a 24-stage, SIMD-wide pipeline. A warp's next macro-op
becomes ready `pipeline_depth` cycles after its compute op is issued, or
when its slowest memory transaction completes (memory divergence: all
threads of the warp wait for the slowest — §1). Idle cycles are issue
cycles in which no warp is ready (§3). The DRAM system is a set of memory
controllers, each a bandwidth server (fixed access latency + per-64 B
transaction bus occupancy); SW+'s ideal coalescing merges read requests
with in-flight requests to the same block across the whole SM.

The scheduling loop itself runs as the family kernels of
:mod:`repro_torch.core.warpsim._cuda` (``engine="cuda"``) or their plain
PyTorch versions on the CPU (``engine="torch"``). This module turns a
loop's ``(raw_cycles, offchip, merged, l1_hits)`` into a
:class:`SimResult` with the host-side stream totals, in the same
arithmetic and order as the reference.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import WarpStream, simd_efficiency


@dataclasses.dataclass
class SimResult:
    name: str
    machine: str
    cycles: float
    thread_insns: int
    mem_insns: int                # thread-level memory instructions
    offchip_requests: int         # DRAM transactions after all merging
    merged_requests: int          # requests absorbed by ideal coalescing
    l1_hits: int
    idle_cycles: float
    busy_cycles: float
    simd_eff: float

    @property
    def ipc(self) -> float:
        return self.thread_insns / max(self.cycles, 1.0)

    @property
    def coalescing_rate(self) -> float:
        """Paper eq. (1): off-chip requests per memory instruction (lower
        is better coalescing)."""
        return self.offchip_requests / max(self.mem_insns, 1)

    @property
    def idle_share(self) -> float:
        return self.idle_cycles / max(self.cycles, 1.0)


def stream_totals(st: WarpStream) -> tuple:
    """Order-independent totals ``(thread_insns, mem_insns, total_busy,
    simd_eff)`` of a stream — the host-side half of a result."""
    return (int(st.tins.sum()), int(st.maccs.sum()),
            float(st.issue.sum()), simd_efficiency(st))


def loop_result(name: str, cfg: MachineConfig, loop: tuple,
                totals: tuple) -> SimResult:
    """Assemble a SimResult from a scheduling loop's
    ``(raw_cycles, offchip, merged, l1_hits)`` and :func:`stream_totals`."""
    raw_cycles, offchip, merged, l1_hits = loop
    thread_insns, mem_insns, total_busy, eff = totals
    n_sms = cfg.num_sms
    cycles = max(raw_cycles, 1.0)
    # Idle share: scheduler slots with nothing to issue, averaged over SMs.
    idle = n_sms * cycles - total_busy
    return SimResult(
        name=name,
        machine=cfg.name,
        cycles=cycles,
        thread_insns=thread_insns,
        mem_insns=mem_insns,
        offchip_requests=offchip,
        merged_requests=merged,
        l1_hits=l1_hits,
        idle_cycles=idle / n_sms,
        busy_cycles=total_busy / n_sms,
        simd_eff=eff,
    )


def simulate(name: str, stream: WarpStream, cfg: MachineConfig,
             engine: str = "auto", device="cuda") -> SimResult:
    """Run the timing model for one stream on one machine.

    ``engine="cuda"`` launches the family kernels (a one-unit family) on a
    CUDA `device`; ``engine="torch"`` runs their plain versions on the CPU;
    ``"auto"`` resolves from `device`.
    """
    loop = _cuda.run_family([(stream, cfg)], device, engine)[0]
    return loop_result(name, cfg, loop, stream_totals(stream))
