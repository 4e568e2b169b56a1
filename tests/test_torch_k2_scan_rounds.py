"""K2's rescan rounds: ``_cuda.scan_rounds`` and the
``warpsim_k2_scan_rounds_total{placement}`` counter.

* On the CPU: the rounds of a unit against the header's register bound
  (``WS_K * WS_LANES`` of ``csrc/warpsim_family.cuh``), and ``collect``
  adding a launch's steps times its rounds.
* On a card (``gpu``-marked, skipping without one): a one-unit launch of
  528 warps on a V100-shaped machine adds 1 round a step; K2's bands on
  a V100-shaped family whose widest units have 10,240 warps, on units
  that keep their state in shared memory, and on a unit of 66,000 warps
  (bands of 512 warps, two rounds), bit for bit with the host C core.
  (``tests/test_torch_warpsim.py`` holds the CUDA source's host build of
  the same bands against the JAX package's C core on the CPU.)
  ``PYTHONPATH=src python -m pytest -m gpu
  tests/test_torch_k2_scan_rounds.py``.

This file imports no JAX: the card's test compares the port with its
host engine.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
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
    (1, 0), (32, 0), (255, 0), (256, 0), (257, 1), (264, 1), (512, 1),
    (513, 1), (528, 1), (1024, 1), (2048, 1), (5120, 1), (10240, 1),
    (65536, 1), (65537, 2)])
def test_scan_rounds_are_zero_in_registers_and_a_ceiling_above(n_warps,
                                                                rounds):
    assert _cuda.scan_rounds(n_warps) == rounds


def test_register_bound_is_the_headers_ws_k_times_ws_lanes():
    text = HEADER.read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
              for name in ("WS_K", "WS_LANES")}
    assert _cuda.REGISTER_WARPS == consts["WS_K"] * consts["WS_LANES"]
    # The bands' rescan is the branch above that bound.
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
    8,448 threads: one unit of 528 warps adds 1 round a step, in the
    ``global`` placement's counter or the ``shared`` one's, and its loop
    equals the host C engine's. (The name is from when a lane rescanned
    all its own warps, 3 rounds a step at 528 warps; now the lane reads
    only its part of the warp's band, one round.)"""
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
    assert sum(snap["warpsim_k2_scan_rounds_total"].values()) == steps
    assert got == _native.run_scheduling_loop(*args)


def _v100_units(n_threads):
    """BFS's streams on the ``v100`` configuration's six machines: the
    paper's machines at SIMD 16 on an 80-SM V100."""
    wl = trace.get_workload("BFS", n_threads=n_threads, seed=0)
    cfgs = ([machines.baseline(w, 16, **V100) for w in (16, 32, 64, 128)]
            + [machines.sw_plus(16, **V100), machines.lw_plus(16, **V100)])
    return [(_cuda.stream_cols(divergence.expand_stream(wl, c)), c)
            for c in cfgs]


def _two_sm_units(n_threads):
    """BFS's streams on 2-SM machines, whose state fits shared memory:
    units of 2,048 and 1,024 warps (lanes' parts of bands) beside one of
    256 (registers) at 16,384 threads."""
    wl = trace.get_workload("BFS", n_threads=n_threads, seed=0)
    cfgs = [machines.baseline(8, num_sms=2), machines.baseline(16, num_sms=2),
            machines.lw_plus(num_sms=2)]
    return [(_cuda.stream_cols(divergence.expand_stream(wl, c)), c)
            for c in cfgs]


def wide_cols(n_warps, seed=0):
    """One synthetic stream of `n_warps` warps: a one-block load, then a
    compute op, each warp; issue cycles 0-2, so ready times tie often."""
    rng = np.random.default_rng(seed)
    n_ops = 2 * n_warps
    return _cuda.StreamCols(
        n_warps=n_warps,
        op_start=np.arange(0, n_ops + 1, 2, dtype=np.int64),
        issue=rng.integers(0, 3, n_ops).astype(np.int64),
        kind=np.tile(np.array([1, 0], dtype=np.int8), n_warps),
        blk_off=np.repeat(np.arange(n_warps, dtype=np.int64), 2),
        blk_len=np.tile(np.array([1, 0], dtype=np.int64), n_warps),
        blocks=rng.integers(0, 4096, n_warps).astype(np.int64),
        nbytes=np.full(n_warps, 64, dtype=np.int64))


def _wide_units(n_warps):
    """:func:`wide_cols` on a 4-SM machine and its SW+ twin: above 65,536
    warps, bands wider than 256 warps."""
    cols = wide_cols(n_warps)
    return [(cols, machines.baseline(4, 4, num_sms=4)),
            (cols, machines.sw_plus(4, num_sms=4))]


def _native_loops(units):
    return [_native.run_scheduling_loop(*u, cfg) for u, cfg in units]


@pytest.mark.gpu
def test_k2_bands_match_c_core_on_the_card(card):
    """K2's bands on the card, bit for bit with the host C core: the
    ``v100`` family at 163,840 threads, whose ws16 and SW+ units have
    10,240 warps (``global``: whole bands, in the lanes' registers 0 and
    1), 2-SM units of 1,024 and 2,048 warps in both placements (lanes'
    parts of bands), and units of 66,000 warps (two rounds a band)."""
    v100 = _v100_units(163840)
    assert max(u.n_warps for u, _cfg in v100) == 10240
    for units, fits in ((v100, False), (_two_sm_units(16384), True),
                        (_wide_units(66000), False)):
        want = _native_loops(units)
        fam = _cuda.marshal(units, device=card)
        assert (_cuda.placement(fam) == "shared") == fits
        for where in _cuda.PLACEMENTS if fits else ("global",):
            cycles, counts = _cuda.simulate_family(fam, where=where)
            torch.cuda.synchronize()
            got = [(c, o, m, h) for c, (o, m, h) in zip(
                cycles.cpu().tolist(), counts.cpu().tolist())]
            assert got == want, where
