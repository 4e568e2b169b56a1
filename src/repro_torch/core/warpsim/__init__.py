"""Warp-level SIMT timing model of *Investigating Warp Size Impact in
GPUs* (Lashgar, Baniasadi, Khonsari 2012), on PyTorch and CUDA.

The main path is the paper's experiment: ``api.Session().run(api.Study())``
covers the 15 benchmarks x ``machines.paper_suite()`` (ws8, ws16, ws32,
ws64, SW+, LW+). The host builds one ThreadTrace per trace family and one
WarpStream per expansion key in numpy; one launch of the family kernels
(``_cuda``, CUDA C++ for sm_90a) then simulates every (expansion key x
machine) unit of the family on the card.

Public API:
    api.Session / api.Study / api.StudyResult
    MachineConfig, machines.{baseline, sw_plus, lw_plus, paper_suite}
    trace.get_workload / trace.BENCHMARKS
    sweep.SweepSpec / sweep.run_sweep_with_stats
    timing.simulate / timing.SimResult
    runner.suite_summary

Engines: ``"cuda"`` (the kernels, on a CUDA device), ``"torch"`` (their
plain PyTorch versions, on the CPU), ``"auto"`` (resolves from the
device). Entry points default to ``device="cuda"``; without a card, or
when a kernel fails to build or launch, they raise.

``python -m repro_torch.core.warpsim`` runs the paper study on the card
and prints the headline table.
"""

from repro_torch.core.warpsim import api, machines, runner, sweep, trace
from repro_torch.core.warpsim.api import Session, Study, StudyResult
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    WarpStream, expand_stream, simd_efficiency,
)
from repro_torch.core.warpsim.sweep import SweepSpec, run_sweep_with_stats
from repro_torch.core.warpsim.timing import SimResult, simulate

__all__ = [
    "MachineConfig", "api", "machines", "runner", "sweep", "trace",
    "Session", "Study", "StudyResult",
    "WarpStream", "expand_stream", "simd_efficiency",
    "SimResult", "simulate", "SweepSpec", "run_sweep_with_stats",
]
