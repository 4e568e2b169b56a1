"""The traffic generator, and each mix's semantics through the harness
with engine ``torch`` (the family kernels' plain versions on the CPU)."""

import itertools

from warpbench import run, spec
from warpbench.tests import tiny
from warpbench.traffic import Traffic, workload_seed

SEED = 2 ** 31 + 3


def test_fresh_seeds_never_repeat_and_follow_the_seed():
    t = Traffic(spec.find_cell("paper-t1.cold").traffic, SEED)
    steps = list(itertools.islice(t.steps(), 50))
    seeds = [s.seed for s in steps] + [t.warmup().seed]
    assert len(set(seeds)) == 51
    assert all(s.points == ({},) for s in steps)
    again = Traffic(spec.find_cell("paper-t1.cold").traffic, SEED)
    assert [s.seed for s in itertools.islice(again.steps(), 50)] == seeds[:50]
    assert workload_seed(SEED + 1, 1) != workload_seed(SEED, 1)


def test_memsweep_walks_each_point_once_with_every_l1_size_a_step():
    params = spec.find_cell("fig1-t1.memsweep").traffic
    t = Traffic(params, SEED)
    steps = list(t.steps())
    assert len(steps) == 15
    assert len({s.seed for s in steps} | {t.warmup().seed}) == 1
    points = [tuple(sorted(p.items())) for s in steps for p in s.points]
    assert len(points) == len(set(points)) == 60
    for s in steps:
        assert sorted(p["l1_size_bytes"] for p in s.points) == \
            params["per_step"]["l1_size_bytes"]
        assert len({(p["dram_latency_cycles"], p["dram_bw_gbps"])
                    for p in s.points}) == 1
    assert {(420, 76.8, 49152)} <= {
        (p["dram_latency_cycles"], p["dram_bw_gbps"], p["l1_size_bytes"])
        for s in steps for p in s.points}
    warm = [tuple(sorted(p.items())) for p in t.warmup().points]
    assert not set(warm) & set(points)
    other = [s.points for s in Traffic(params, SEED + 1).steps()]
    assert other != [s.points for s in steps]


def test_grids_split_a_configuration_by_machine_set_and_thread_count():
    config = spec.find_cell("fig1-t1.memsweep").config
    studies = run.grids(config, {"l1_size_bytes": 16384})
    assert len(studies) == 6
    assert [len(m) for m, _b, _n in studies] == [4] * 6
    assert {n for _m, _b, n in studies} == {16384, 8192}
    assert sum(len(b) for _m, b, _n in studies) == 45
    m = studies[0][0]["simd8_ws8"]
    assert (m["num_sms"], m["l1_size_bytes"], m["warp_size"]) == (16, 16384, 8)
    assert run.working_set(config) == (15, 180)
    assert run.working_set(spec.find_cell("paper-t1.cold").config) == (15, 75)


def test_cold_misses_the_result_cache_and_builds_in_the_window():
    r, out, numbers, sample = run.run_cell(tiny.cell("paper-t1.cold"), SEED,
                                           1.5, False, "cpu")
    # Each step builds its own traces and streams (however many the
    # window's time held).
    assert out["correct"] and r.steps >= 1
    c = r.counters
    assert c["result_cache_hits"] == 0 and c["cache_hits"] == 0
    assert c["simulated"] == r.cells == out["attempted"]
    assert c["trace_builds"] == 3 * r.steps
    assert c["aggregations"] == 3 * 5 * r.steps
    # A cell of each of the 6 machines at each of the 2 thread counts.
    assert {(d.machine["name"], d.n_threads) for d in sample} == {
        (m, n) for m in ("ws8", "ws16", "ws32", "ws64", "SW+", "LW+")
        for n in (512, 256)}


def test_memsweep_builds_nothing_in_the_window_and_runs_each_point_once():
    r, out, numbers, sample = run.run_cell(tiny.cell("fig1-t1.memsweep"),
                                           SEED, 0.5, False, "cpu")
    assert out["correct"] and r.steps >= 1
    c = r.counters
    assert c["trace_builds"] == 0 and c["aggregations"] == 0
    assert c["result_cache_hits"] == 0 and c["cache_hits"] == 0
    # 4 L1 sizes x 3 SIMD widths x 4 warp sizes x 3 benchmarks a step.
    assert r.cells == r.steps * 4 * 12 * 3 == c["expansion_hits"]
    machines = {(d.machine["dram_latency_cycles"], d.machine["dram_bw_gbps"],
                 d.machine["l1_size_bytes"]) for d in sample}
    assert all(lat != 470 for lat, _bw, _l1 in machines)
    # A cell of each machine at each thread count and each L1 size.
    assert len({(d.machine["name"], d.n_threads, d.machine["l1_size_bytes"])
                for d in sample}) == 12 * 2 * 4
