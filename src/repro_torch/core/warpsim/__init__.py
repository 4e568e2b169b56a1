"""Warp-level SIMT timing model of *Investigating Warp Size Impact in
GPUs* (Lashgar, Baniasadi, Khonsari 2012), on PyTorch and CUDA.

The main path is the paper's experiment: ``api.Session().run(api.Study())``
covers the 15 benchmarks x ``machines.paper_suite()`` (ws8, ws16, ws32,
ws64, SW+, LW+). The host builds one ThreadTrace per trace family and one
WarpStream per expansion key (the C aggregation core of ``_native``); one
launch of the family kernels (``_cuda``, CUDA C++ for sm_90a) then
simulates every (expansion key x machine) unit of the family on the card,
while the host prepares the next family.

Public API:
    api.Session (``cache_dir=``, ``Session.cell``, ``cache_stats``) /
        api.Study (``warp_sizes``, ``Study.warp_size_range``) /
        api.StudyResult
    MachineConfig, machines.{baseline, sw_plus, lw_plus, paper_suite,
        warp_size_sweep, sharing_plan}
    trace.get_workload / trace.BENCHMARKS
    sweep.SweepSpec / sweep.run_sweep / sweep.run_sweep_with_stats /
        sweep.ResultCache / sweep.TraceCache / sweep.cell_key /
        sweep.expansion_key
    timing.simulate / timing.SimResult
    divergence.expand_stream / expand_workload / expand_stream_single
    runner.run_one / runner.run_suite / runner.suite_summary
    faults.FaultPlan / faults.ServiceError / faults.ServiceUnavailable

Timing engines (``simulate(..., engine=...)``, ``Study(engine=...)`` —
all bit for bit the same):

    ============= ===================================================
    engine        what it is
    ============= ===================================================
    auto          resolves from the device: cuda on a card, torch on
                  the CPU (never a host engine)
    cuda          the family kernels (K2, CUDA C++ for sm_90a); a
                  sweep simulates a whole trace family in ONE launch
    torch         their plain PyTorch versions, on the CPU
    native        the scheduling loop in C (``csrc/warpsim_loop.c``),
                  on the host CPU
    fast          the flat-CSR loop in Python, on the host CPU
    fast_nested   its earlier generation (sweep_bench's cold_pr1)
    event         the event loop: the model's specification
    ============= ===================================================

The four host engines run on the host CPU whatever the device, when a
caller names them; sweeps run them serially or in a process pool
(``run_sweep_with_stats(parallel=..., max_workers=...)``; the family
engines never use one), with the reference's baseline modes
(``group_expansion``, ``reuse_expansion``, ``share_traces``).
``benchmarks.sweep_bench`` times the card's cold study against them.
Entry points default to ``device="cuda"``; without a card, or when a
kernel fails to build or launch, they raise.

``python -m repro_torch.core.warpsim`` runs the paper study on the card
and prints the headline table (``--dense``: and the 4..128 sweep).
"""

from repro_torch.core.warpsim import api, machines, runner, sweep, trace
from repro_torch.core.warpsim.api import Session, Study, StudyResult
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    WarpStream, expand_stream, expand_workload, simd_efficiency,
)
from repro_torch.core.warpsim.faults import (
    FaultPlan, ServiceError, ServiceUnavailable,
)
from repro_torch.core.warpsim.sweep import (
    ResultCache, SweepSpec, expansion_key, run_sweep, run_sweep_with_stats,
)
from repro_torch.core.warpsim.timing import SimResult, simulate

__all__ = [
    "MachineConfig", "api", "machines", "runner", "sweep", "trace",
    "Session", "Study", "StudyResult",
    "FaultPlan", "ServiceError", "ServiceUnavailable",
    "WarpStream", "expand_stream", "expand_workload", "simd_efficiency",
    "SimResult", "simulate",
    "ResultCache", "SweepSpec", "expansion_key", "run_sweep",
    "run_sweep_with_stats",
]
