"""K2's rescan rounds: ``_cuda.scan_rounds`` and the
``warpsim_k2_scan_rounds_total{placement}`` counter.

* On the CPU: the rounds of a unit against the header's register bound
  (``WS_K * WS_LANES`` of ``csrc/warpsim_family.cuh``), and ``collect``
  adding a launch's steps times its rounds.
* On a card (``gpu``-marked, skipping without one): a one-unit launch of
  528 warps on a V100-shaped machine adds 3 rounds a step.
  ``PYTHONPATH=src python -m pytest -m gpu
  tests/test_torch_k2_scan_rounds.py``.

This file imports no JAX: the card's test compares the port with its
host engine.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim import _native
from repro_torch.core.warpsim import divergence
from repro_torch.core.warpsim import machines
from repro_torch.core.warpsim import obs
from repro_torch.core.warpsim import trace

HEADER = Path(_cuda.__file__).resolve().parent / "csrc" / "warpsim_family.cuh"
V100 = dict(num_sms=80, threads_per_sm=2048, num_mem_ctrls=8,
            dram_bw_gbps=180.0, core_clock_ghz=1.53, l1_size_bytes=131072)


@pytest.mark.parametrize("n_warps,rounds", [
    (1, 0), (32, 0), (255, 0), (256, 0), (257, 2), (264, 2), (512, 2),
    (513, 3), (528, 3), (1024, 4), (2048, 8), (5120, 20), (10240, 40)])
def test_scan_rounds_are_zero_in_registers_and_a_ceiling_above(n_warps,
                                                                rounds):
    assert _cuda.scan_rounds(n_warps) == rounds


def test_register_bound_is_the_headers_ws_k_times_ws_lanes():
    text = HEADER.read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
              for name in ("WS_K", "WS_LANES")}
    assert _cuda.REGISTER_WARPS == consts["WS_K"] * consts["WS_LANES"]
    # The lane's rescan is the branch above that bound.
    assert "if (nw > WS_K * WS_LANES)" in text


class _Event:
    def elapsed_time(self, end):
        return 4.0          # ms


def test_collect_adds_the_longest_units_steps_times_its_rounds():
    """A launch's timing, read after its wait, adds steps x rounds to its
    placement's counter (0 for a unit in registers, whose label is made
    all the same)."""
    ob = obs.Observability()
    wl = trace.get_workload("BFS", n_threads=128, seed=0)
    cfg = machines.baseline(8)
    launch = _cuda.launch_family([(divergence.expand_stream(wl, cfg), cfg)],
                                 device="cpu")
    with obs.bind(ob):
        _cuda.collect(dataclasses.replace(
            launch, k2=_cuda.K2Timing(_Event(), _Event(), "global", 700, 3)))
        _cuda.collect(dataclasses.replace(
            launch, k2=_cuda.K2Timing(_Event(), _Event(), "global", 100,
                                      40)))
        _cuda.collect(dataclasses.replace(
            launch, k2=_cuda.K2Timing(_Event(), _Event(), "shared", 50)))
    snap = ob.registry.snapshot()
    assert snap["warpsim_k2_scan_rounds_total"] == {
        '{placement="global"}': 700 * 3 + 100 * 40,
        '{placement="shared"}': 0}
    assert snap["warpsim_k2_steps_total"] == {
        '{placement="global"}': 800, '{placement="shared"}': 50}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_528_warp_unit_adds_three_rounds_a_step_on_the_card(card):
    """``run_scheduling_loop`` on an 80-SM machine at warp size 16 and
    8,448 threads: one unit of 528 warps, in the ``global`` placement's
    counter or the ``shared`` one's, 3 rounds a step; its loop equals the
    host C engine's."""
    cfg = machines.baseline(16, 16, **V100)
    wl = trace.get_workload("BFS", n_threads=8448, seed=0)
    s = divergence.expand_stream(wl, cfg)
    assert s.n_warps == 528
    args = (s.n_warps, s.op_start, s.issue, s.kind, s.blk_off, s.blk_len,
            s.blocks, s.nbytes, cfg)
    ob = obs.Observability()
    with obs.bind(ob):
        got = _cuda.run_scheduling_loop(*args, device=card)
    snap = ob.registry.snapshot()
    steps = sum(snap["warpsim_k2_steps_total"].values())
    assert steps == len(s.issue)
    assert sum(snap["warpsim_k2_scan_rounds_total"].values()) == 3 * steps
    assert got == _native.run_scheduling_loop(*args)
