"""The ``v100`` configuration, the ``hbmsweep`` traffic, the cells
``v100.hbmsweep`` and ``paper-t1.memsweep``, and the readers of the
metrics of K2's wide units."""

import sys

import pytest

from warpbench import run, spec
from warpbench.run import Run
from warpbench.tests import tiny
from warpbench.traffic import Traffic

SEED = 2 ** 31 + 7
WIDE = ("k2.wide_ns_per_step", "k2.wide_roofline", "k2.scan_rounds_per_step")


def test_v100_and_hbmsweep_load_through_the_cell():
    cell = spec.find_cell("v100.hbmsweep")
    c = cell.config
    assert c["name"] == "v100" and cell.chips == 1
    assert c["reference"] == "warpbench/reference" and c["reduced"] == []
    assert len(c["source"]) <= 200 and "V100 whitepaper" in c["source"]
    assert c["machine"] == {
        "num_sms": 80, "threads_per_sm": 2048, "pipeline_depth": 24,
        "core_clock_ghz": 1.53, "num_mem_ctrls": 8, "dram_bw_gbps": 180.0,
        "dram_latency_cycles": 420, "transaction_bytes": 64,
        "l1_size_bytes": 131072, "l1_ways": 8, "l1_hit_latency": 1}
    # 900 GB/s aggregate, as the model scales the 16-SM share.
    assert c["machine"]["dram_bw_gbps"] * 80 / 16 == 900.0
    (mset,) = c["machine_sets"]
    assert {n: (m["warp_size"], m["simd_width"], m["ideal_coalescing"],
                m["mimd"]) for n, m in mset.items()} == {
        "ws16": (16, 16, False, False), "ws32": (32, 16, False, False),
        "ws64": (64, 16, False, False), "ws128": (128, 16, False, False),
        "SW+": (16, 16, True, False), "LW+": (128, 16, False, True)}
    half = {"MP", "MU", "NQU"}
    assert c["threads"] == {b: 81920 if b in half else 163840
                            for b in spec.find_cell("paper-t1.cold")
                            .config["threads"]}
    assert c["guarantees"] == spec.find_cell(
        "paper-t1.cold").config["guarantees"]
    assert run.working_set(c) == (15, 75)
    assert cell.traffic["workload_seeds"] == "fixed"
    assert [m["name"] for m in cell.per_layer] == list(WIDE)
    memsweep = spec.find_cell("paper-t1.memsweep")
    assert memsweep.traffic == spec.find_cell("fig1-t1.memsweep").traffic
    assert [m["name"] for m in memsweep.per_layer] == [
        "k2.scan_rounds_per_step"]


def test_hbmsweep_walks_80_distinct_points_one_grid_each():
    params = spec.find_cell("v100.hbmsweep").traffic
    t = Traffic(params, SEED)
    steps = list(t.steps())
    assert len(steps) == 80
    assert all(len(s.points) == 1 for s in steps)
    assert len({s.seed for s in steps} | {t.warmup().seed}) == 1
    points = [tuple(sorted(s.points[0].items())) for s in steps]
    assert len(set(points)) == 80
    assert {p["dram_bw_gbps"] for s in steps for p in s.points} == {
        146.4, 180.0, 226.8, 311.0}
    assert ((("dram_bw_gbps", 180.0), ("dram_latency_cycles", 420),
             ("l1_size_bytes", 131072)) in points)
    warm = [tuple(sorted(p.items())) for p in t.warmup().points]
    assert len(warm) == 1 and not set(warm) & set(points)
    assert [s.points for s in Traffic(params, SEED + 1).steps()] != [
        s.points for s in steps]
    # The check's strata are a machine at a thread count.
    assert t.stratum({"name": "ws16"}, 163840) == ("ws16", 163840)


def test_tiny_v100_hbmsweep_runs_correct_on_the_cpu():
    cell = tiny.cell("v100.hbmsweep")
    r, out, numbers, sample = run.run_cell(cell, SEED, 0.3, False, "cpu")
    assert out["correct"] and r.steps >= 1
    c = r.counters
    assert c["trace_builds"] == 0 and c["aggregations"] == 0
    assert c["result_cache_hits"] == 0 and c["cache_hits"] == 0
    # 6 machines x 3 benchmarks, one grid a step; ws16 and SW+ share a
    # stream, so 5 streams a benchmark.
    assert r.cells == r.steps * 6 * 3
    assert c["expansion_hits"] == r.steps * 5 * 3
    assert {(d.machine["name"], d.n_threads) for d in sample} == {
        (m, n) for m in ("ws16", "ws32", "ws64", "ws128", "SW+", "LW+")
        for n in (512, 256)}
    assert all(d.machine["dram_latency_cycles"] != 470 for d in sample)
    assert numbers == {"records_differing": 0, "cycles_max_rel_gap": 0.0}


def test_readers_read_nothing_without_data(monkeypatch):
    from repro_torch.core.warpsim import obs
    monkeypatch.setattr(obs, "default", lambda: obs.Observability())
    for name in WIDE:
        assert spec.reader(name)(Run()) is None
    monkeypatch.delitem(sys.modules, "repro_torch.core.warpsim.obs")
    assert spec.reader("k2.scan_rounds_per_step")(Run()) is None


def test_wide_k2_readers_compute_what_their_namesakes_compute():
    r = Run(launches=[(1000, 250_000), (3000, 600_000)],
            device={"k2_s": 0.02, "busy_s": 0.03, "window_s": 0.04})
    assert spec.reader("k2.wide_ns_per_step")(r) == pytest.approx(
        1e9 * 0.02 / 4000)
    assert spec.reader("k2.wide_roofline")(r) == pytest.approx(
        100.0 * 850_000 / 3.35e12 / 0.02)
    for wide, base in (("k2.wide_ns_per_step", "k2.ns_per_step"),
                       ("k2.wide_roofline", "k2_roofline")):
        assert spec.reader(wide)(r) == spec.reader(base)(r)
        assert spec.reader(wide)(Run(launches=[(5, 5)])) is None


def test_scan_rounds_reader_divides_rounds_by_steps_over_placements(
        monkeypatch):
    from repro_torch.core.warpsim import _cuda, obs
    ob = obs.Observability()
    monkeypatch.setattr(obs, "default", lambda: ob)
    _secs, steps = _cuda.k2_metrics(ob)
    rounds = _cuda.k2_scan_rounds(ob)
    for placement, n, k in (("global", 1000, 40), ("global", 300, 20),
                            ("shared", 700, 0)):
        steps.labels(placement=placement).inc(n)
        rounds.labels(placement=placement).inc(n * k)
    read = spec.reader("k2.scan_rounds_per_step")
    assert read(Run()) == pytest.approx((40_000 + 6_000) / 2000)
    # A program without the rounds counter (an older one) reads None.
    ob2 = obs.Observability()
    _cuda.k2_metrics(ob2)[1].labels(placement="global").inc(10)
    monkeypatch.setattr(obs, "default", lambda: ob2)
    assert read(Run()) is None


def test_new_cells_fit_the_run_budget():
    """2 + 14 runs a cell of run_seconds + 60 s, 180 s more a cell and
    1,200 s spare, within 43,200 s."""
    bench = spec.load_benchmark()
    n = len(bench["workloads"])
    assert (2 + 14 * n) * (bench["run_seconds"] + 60) + 180 * n + 1200 \
        <= 43200
