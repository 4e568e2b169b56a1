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
        sweep.ResultCache / sweep.TraceCache / sweep.cell_key
    timing.simulate / timing.SimResult
    runner.run_one / runner.run_suite / runner.suite_summary

Engines: ``"cuda"`` (the kernels, on a CUDA device), ``"torch"`` (their
plain PyTorch versions, on the CPU), ``"auto"`` (resolves from the
device). Entry points default to ``device="cuda"``; without a card, or
when a kernel fails to build or launch, they raise.

``python -m repro_torch.core.warpsim`` runs the paper study on the card
and prints the headline table (``--dense``: and the 4..128 sweep).
"""

from repro_torch.core.warpsim import api, machines, runner, sweep, trace
from repro_torch.core.warpsim.api import Session, Study, StudyResult
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    WarpStream, expand_stream, simd_efficiency,
)
from repro_torch.core.warpsim.sweep import (
    ResultCache, SweepSpec, run_sweep, run_sweep_with_stats,
)
from repro_torch.core.warpsim.timing import SimResult, simulate

__all__ = [
    "MachineConfig", "api", "machines", "runner", "sweep", "trace",
    "Session", "Study", "StudyResult",
    "WarpStream", "expand_stream", "simd_efficiency",
    "SimResult", "simulate", "SweepSpec", "ResultCache", "run_sweep",
    "run_sweep_with_stats",
]
