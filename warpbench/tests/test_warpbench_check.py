"""How ``correct`` is decided: the reference against the program, the
control that has to come out not correct, and a run with the timed path
broken underneath, which has to come out not correct too."""

import dataclasses

import numpy as np
import pytest
import torch

from warpbench import check, control, faults, reference, run
from warpbench.tests import tiny

SEED = 2 ** 31 + 11


def _machine(**kw):
    from repro_torch.core.warpsim.config import MachineConfig
    return dataclasses.asdict(MachineConfig(**kw))


@pytest.mark.parametrize("num_sms,n_threads", [(2, 256), (16, 1024)])
def test_the_reference_gives_the_programs_records(num_sms, n_threads):
    from repro_torch.core.warpsim import divergence, machines, timing
    from repro_torch.core.warpsim.trace import BENCHMARKS, get_workload
    suite = machines.paper_suite(8)
    suite.update(machines.warp_size_sweep(32))
    cells, want = [], []
    for bench in BENCHMARKS:
        wl = get_workload(bench, n_threads=n_threads, seed=SEED)
        for name, cfg in suite.items():
            cfg = dataclasses.replace(cfg, num_sms=num_sms)
            stream = divergence.expand_stream(wl, cfg)
            want.append(dataclasses.asdict(
                timing.simulate(bench, stream, cfg, engine="fast")))
            cells.append((bench, n_threads, SEED, dataclasses.asdict(cfg)))
    assert reference.records(cells) == want


def test_the_control_comes_out_not_correct():
    """The reference with ties issued to the later warp, in the program's
    place, fails the comparison; float32 does not (every time of the model
    is a multiple of 1/128 cycle and fits its 24-bit mantissa)."""
    cells = [("BFS", 512, SEED, _machine(name="ws8", warp_size=8,
                                          num_sms=2)),
             ("MP", 256, SEED, _machine(name="SW+", warp_size=8,
                                         ideal_coalescing=True, num_sms=2)),
             ("BKP", 512, SEED, _machine(name="LW+", warp_size=64, mimd=True,
                                          num_sms=2))]
    recs = reference.records(cells)
    done = [check.Done(b, n, s, m, r, r)
            for (b, n, s, m), r in zip(cells, recs)]
    assert check.verdict(check.compare(done)[0])
    for settings, fails in (({"later_first": True}, True),
                            ({"ftype": np.float32}, False)):
        numbers = control.in_place(done, **settings)
        assert check.verdict(numbers) is not fails, settings
    numbers = control.in_place(done, later_first=True)
    assert numbers["records_differing"] == 3
    assert numbers["cycles_max_rel_gap"] > 0


def test_control_readings_in_one_process():
    row = control.readings(tiny.cell("paper-t1.cold"), SEED, 0.1, "cpu")
    assert row["program"] == {"records_differing": 0,
                              "cycles_max_rel_gap": 0.0}
    assert row["control"]["records_differing"] > 0
    assert row["float32"]["records_differing"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["paper-t1.cold", "fig1-t1.memsweep"])
def test_a_broken_timed_path_comes_out_not_correct(name, fault):
    with faults.planted(fault):
        _run, out, numbers, _sample = run.run_cell(tiny.cell(name), SEED,
                                                   0.1, False, "cpu")
    assert not out["correct"]
    assert numbers["records_differing"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["paper-t1.cold", "fig1-t1.memsweep"])
def test_a_tiny_cell_on_the_card_is_correct_and_its_control_is_not(card,
                                                                   name):
    row = control.readings(tiny.cell(name), SEED, 0.1, card)
    assert row["program"]["records_differing"] == 0
    assert row["control"]["records_differing"] > 0


def test_the_sample_holds_a_cell_of_each_stratum_and_the_longest():
    strata = ["a", "b", "a", "c", "b", "a"]
    cycles = [1.0, 2.0, 9.0, 3.0, 4.0, 5.0]
    picked = check.pick(strata, cycles, SEED)
    assert sorted({strata[i] for i in picked}) == ["a", "b", "c"]
    assert 2 in picked and len(picked) <= 4
    assert picked == check.pick(strata, cycles, SEED)
    assert check.pick([], [], SEED) == []
