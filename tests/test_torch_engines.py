"""The port's host timing engines and sweep modes held against the
reference's, on the CPU. Every equality is exact (``==``, no tolerance).

* ``timing.simulate`` with each host engine (``event``, ``fast``,
  ``fast_nested``, ``native``) on every benchmark at 128 threads x the
  paper suite and one odd geometry (3 SMs, 5 controllers, a 6-way L1):
  equal to the reference's same engine and to the port's ``torch``
  engine, from a WarpStream and from per-warp ``WarpOp`` lists.
* ``WarpStream.to_warp_ops`` (every ``WarpOp`` field),
  ``expand_stream_single`` (every column, against both packages'
  ``expand_stream`` and the reference's ``expand_stream_single``) and
  ``expand_workload``.
* ``L1Cache`` and ``DRAM`` on a seeded access sequence; ``program_stats``
  and the paper's benchmark classes.
* ``run_sweep_with_stats`` in the reference's three modes (the
  ``cold_pr1`` mode, the ``cold_pr2`` mode, the current one), serially
  with ``native`` and ``fast`` and in a pool of 2 with ``native``:
  records and stats equal to the reference's same call; the pool's
  workers hold no torch; ``engine="torch"`` without grouping is one
  one-unit launch a cell; the deprecated ``LAST_SWEEP_STATS``.
* Host engines through the facade and a port daemon (a reference client
  asking for ``engine="event"``), ``runner.run_suite(service_url=...)``.
* ``sweep_bench.run(quick=True, device="cpu")``: its row names, and its
  counter rows against the reference's ``run_sweep_with_stats``.

The ``gpu`` test runs the quick grid through each host engine and the
pool in a process that has launched K2, against the card's records:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_engines.py``.
"""

import concurrent.futures
import dataclasses
import importlib.util
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro.core.warpsim import coalesce as rcoalesce
from repro.core.warpsim import divergence as rdiv
from repro.core.warpsim import machines as rmachines
from repro.core.warpsim import sweep as rsweep
from repro.core.warpsim import timing as rtiming
from repro.core.warpsim import trace as rtrace
import repro.core.warpsim as rwarpsim
from repro_torch.benchmarks import sweep_bench as tsweep_bench
from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim import api as tapi
from repro_torch.core.warpsim import coalesce as tcoalesce
from repro_torch.core.warpsim import divergence as tdiv
from repro_torch.core.warpsim import machines as tmachines
from repro_torch.core.warpsim import runner as trunner
from repro_torch.core.warpsim import sweep as tsweep
from repro_torch.core.warpsim import timing as ttiming
from repro_torch.core.warpsim import trace as ttrace
import repro_torch.core.warpsim as twarpsim
from test_torch_service import cpu_service, encode, live, ref_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_THREADS = 128
HOST = ttiming.HOST_ENGINES
STREAM_FIELDS = ("warp", "issue", "tins", "lanes", "kind", "maccs",
                 "blk_off", "blk_len", "blocks", "nbytes", "op_start")
QUICK = dict(benches=("BFS", "BKP", "MTM", "DYN"), n_threads=N_THREADS)


def _machines(pkg):
    """The paper suite plus one odd geometry (3 SMs, 5 controllers, a
    6-way L1 of 7 sets) on ws16, SW+ and LW+."""
    odd = dict(num_sms=3, num_mem_ctrls=5, l1_ways=6,
               l1_size_bytes=64 * 6 * 7)
    return (list(pkg.paper_suite().values())
            + [pkg.baseline(16, **odd), pkg.sw_plus(**odd),
               pkg.lw_plus(**odd)])


def _same_stream(a, b) -> None:
    assert a.n_warps == b.n_warps
    for f in STREAM_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _op_fields(op) -> tuple:
    blocks = None if op.mem_blocks is None else op.mem_blocks.tolist()
    nbytes = (None if op.mem_block_bytes is None
              else op.mem_block_bytes.tolist())
    return (op.issue_cycles, op.thread_insns, op.lane_slots, blocks, nbytes,
            op.mem_thread_accesses, op.is_load, op.is_mem)


# ------------------------------------------------------------- engines


@pytest.mark.parametrize("bench", rtrace.BENCHMARKS)
def test_host_engines_equal_reference_and_torch(bench):
    ref_wl = rtrace.get_workload(bench, n_threads=N_THREADS)
    port_wl = ttrace.get_workload(bench, n_threads=N_THREADS)
    for rcfg, tcfg in zip(_machines(rmachines), _machines(tmachines)):
        rs = rdiv.expand_stream(ref_wl, rcfg)
        ts = tdiv.expand_stream(port_wl, tcfg)
        want = ttiming.simulate(bench, ts, tcfg, engine="torch",
                                device="cpu").as_dict()
        t_ops = ts.to_warp_ops()
        for engine in HOST:
            ref = rtiming.simulate(bench, rs, rcfg, engine=engine).as_dict()
            got = ttiming.simulate(bench, ts, tcfg, engine=engine,
                                   device="cpu").as_dict()
            assert got == ref == want, (tcfg.name, engine)
            got = ttiming.simulate(bench, t_ops, tcfg, engine=engine,
                                   device="cuda").as_dict()
            assert got == want, (tcfg.name, engine, "WarpOp lists")
    # The family engine takes WarpOp lists too (a one-unit launch).
    got = ttiming.simulate(bench, t_ops, tcfg, engine="torch", device="cpu")
    assert got.as_dict() == want


@pytest.mark.parametrize("bench", rtrace.BENCHMARKS)
def test_expansions_equal_reference(bench):
    ref_wl = rtrace.get_workload(bench, n_threads=N_THREADS)
    port_wl = ttrace.get_workload(bench, n_threads=N_THREADS)
    for rcfg, tcfg in zip(_machines(rmachines), _machines(tmachines)):
        two_phase = tdiv.expand_stream(port_wl, tcfg)
        single = tdiv.expand_stream_single(port_wl, tcfg)
        _same_stream(single, two_phase)
        _same_stream(single, rdiv.expand_stream(ref_wl, rcfg))
        _same_stream(single, rdiv.expand_stream_single(ref_wl, rcfg))
        assert single.n_ops == two_phase.n_ops == len(two_phase.warp)
        ref_ops = rdiv.expand_stream(ref_wl, rcfg).to_warp_ops()
        for port_ops in (two_phase.to_warp_ops(),
                         tdiv.expand_workload(port_wl, tcfg)):
            assert [[_op_fields(op) for op in w] for w in port_ops] == [
                [_op_fields(op) for op in w] for w in ref_ops]
        assert tdiv.simd_efficiency(port_ops) == tdiv.simd_efficiency(
            two_phase) == rdiv.simd_efficiency(ref_ops)
        assert two_phase.flat_csr() is two_phase.flat_csr()


def test_l1_cache_and_dram_equal_reference():
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 400, 5000)
    times = np.cumsum(rng.random(5000) * 30.0)
    nbytes = rng.choice([4, 16, 32, 48, 64], 5000)
    for size, ways in ((48 * 1024, 8), (64 * 6 * 7, 6), (64 * 3, 3)):
        ref_l1 = rcoalesce.L1Cache(size, ways)
        port_l1 = tcoalesce.L1Cache(size, ways)
        assert port_l1.n_sets == ref_l1.n_sets
        for b, t in zip(blocks.tolist(), times.tolist()):
            got, want = port_l1.lookup(b), ref_l1.lookup(b)
            assert got == want
            if got is None or got > t:
                port_l1.fill(b, t + 400.0)
                ref_l1.fill(b, t + 400.0)
    for cfg_r, cfg_t in zip(_machines(rmachines), _machines(tmachines)):
        ref_d, port_d = rtiming.DRAM(cfg_r), ttiming.DRAM(cfg_t)
        for b, t, n in zip(blocks.tolist(), times.tolist(), nbytes.tolist()):
            assert port_d.request(b, t, n) == ref_d.request(b, t, n)
        assert port_d.ctrl_free == ref_d.ctrl_free


def test_program_stats_and_classes_equal_reference():
    for bench in rtrace.BENCHMARKS:
        assert ttrace.program_stats(ttrace.get_workload(bench).program) == \
            rtrace.program_stats(rtrace.get_workload(bench).program)
    for name in ("DIVERGENT", "COALESCING_HUNGRY", "INSENSITIVE"):
        assert getattr(ttrace, name) == getattr(rtrace, name)


def test_engine_names_and_exports():
    for engine in HOST:
        assert _cuda.resolve_engine(engine, "cuda") == engine
        assert _cuda.resolve_engine(engine, "cpu") == engine
    with pytest.raises(ValueError, match="port's is 'cuda'"):
        _cuda.resolve_engine("pallas", "cuda")
    with pytest.raises(ValueError, match="native"):
        _cuda.resolve_engine("nope", "cpu")
    s = tdiv.expand_stream(ttrace.get_workload("DYN", n_threads=64),
                           tmachines.baseline(8))
    with pytest.raises(ValueError, match="unknown engine 'pallas'"):
        ttiming.simulate("DYN", s, tmachines.baseline(8), engine="pallas")
    assert twarpsim.__all__ == rwarpsim.__all__
    for name in ("expand_workload", "expansion_key", "FaultPlan",
                 "ServiceError", "ServiceUnavailable"):
        assert getattr(twarpsim, name).__name__ == getattr(
            rwarpsim, name).__name__


# --------------------------------------------------------- sweep modes


MODES = {"pr1": dict(group_expansion=False, reuse_expansion=False),
         "pr2": dict(share_traces=False), "current": {}}
RUNS = {"native": dict(engine="native", parallel=False),
        "fast": dict(engine="fast", parallel=False),
        "native_pool": dict(engine="native", parallel=True, max_workers=2)}


def _plain(grid) -> dict:
    return {(m, b): dataclasses.asdict(r)
            for m, per in grid.items() for b, r in per.items()}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_modes_equal_reference(mode, run):
    kw = dict(MODES[mode], **RUNS[run])
    rspec = rsweep.SweepSpec(machines=rmachines.paper_suite(), **QUICK)
    tspec = tsweep.SweepSpec(machines=tmachines.paper_suite(), **QUICK)
    want, rstats = rsweep.run_sweep_with_stats(
        rspec, trace_cache=rsweep.TraceCache(),
        expansion_cache=rsweep.ExpansionCache(), **kw)
    got, tstats = tsweep.run_sweep_with_stats(tspec, device="cpu", **kw)
    assert list(_plain(got)) == list(_plain(want))     # the spec's order
    assert _plain(got) == _plain(want)
    assert tstats == rstats
    if mode != "current":
        assert tstats["traces_shared"] == 0


def test_pool_workers_hold_no_torch():
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=tsweep.pool_context()) as ex:
        probes = list(ex.map(tsweep.pool_probe, range(2)))
    assert tsweep.POOL_START_METHOD == "forkserver"
    assert [has_torch for _pid, has_torch in probes] == [False, False]
    assert all(pid != os.getpid() for pid, _ in probes)


def test_family_engine_without_grouping_is_a_launch_a_cell(monkeypatch):
    spec = tsweep.SweepSpec(machines=tmachines.paper_suite(), **QUICK)
    grouped, gstats = tsweep.run_sweep_with_stats(spec, device="cpu")
    assert gstats["family_launches"] == 4
    calls = []
    run_family = _cuda.run_family

    def counted(pairs, *a, **kw):
        calls.append(len(pairs))
        return run_family(pairs, *a, **kw)

    monkeypatch.setattr(_cuda, "run_family", counted)
    got, stats = tsweep.run_sweep_with_stats(spec, device="cpu",
                                             group_expansion=False)
    monkeypatch.undo()
    assert calls == [1] * 24
    assert stats["family_launches"] == 0 and stats["traces_shared"] == 0
    assert stats["expansion_groups"] == stats["trace_families"] == 24
    assert _plain(got) == _plain(grouped)
    # The family engines never start a pool, whatever `parallel` says.
    monkeypatch.setattr(tsweep, "pool_context", None)
    again = tsweep.run_sweep(spec, device="cpu", parallel=True)
    assert _plain(again) == _plain(grouped)


def test_last_sweep_stats_alias_warns():
    spec = tsweep.SweepSpec(benches=("DYN",), n_threads=64,
                            machines={"ws8": tmachines.baseline(8)})
    _, stats = tsweep.run_sweep_with_stats(spec, engine="native",
                                           device="cpu")
    with pytest.warns(DeprecationWarning, match="run_sweep_with_stats"):
        assert tsweep.LAST_SWEEP_STATS == stats
    with pytest.raises(AttributeError):
        tsweep.NOT_A_NAME


def test_expansion_cache_single_phase():
    wl = ttrace.get_workload("MU", n_threads=N_THREADS)
    cfg = tmachines.lw_plus()
    cache = tsweep.ExpansionCache()
    single = cache.get(wl, cfg, single_phase=True)
    _same_stream(single, tdiv.expand_stream(wl, cfg))
    assert cache.get(wl, cfg) is single and cache.hits == 1


# --------------------------------------------- facade, daemon, runner


def test_host_engines_through_facade_and_daemon(tmp_path):
    study = tapi.Study(benches=("BFS", "MTM"), n_threads=N_THREADS,
                       seeds=(0, 1))
    want = ref_records(study)
    for engine in HOST:
        got = tapi.Session(device="cpu").run(
            dataclasses.replace(study, engine=engine))
        assert encode(got.records) == want, engine
    # A reference client posts a study naming a host engine to a port
    # daemon (engine torch, on the CPU): the daemon runs that engine.
    from repro.core.warpsim import api as rapi
    with live(cpu_service(tmp_path)) as url:
        got = rapi.Session(backend=rapi.ServiceBackend(url)).run(
            rapi.Study.from_dict(dict(study.to_dict(), engine="event")))
        assert encode(got.records) == want


def test_run_suite_modes_and_service_url(tmp_path):
    from repro.core.warpsim import runner as rrunner
    want = rrunner.run_suite(benches=("BFS", "NW"), n_threads=N_THREADS,
                             parallel=False)
    plain = {m: {b: r.as_dict() for b, r in rb.items()}
             for m, rb in want.items()}
    for kw in (dict(engine="fast_nested", parallel=False,
                    group_expansion=False, reuse_expansion=False),
               dict(engine="native", share_traces=False,
                    cache=tsweep.ResultCache(str(tmp_path / "c")))):
        got = trunner.run_suite(benches=("BFS", "NW"), n_threads=N_THREADS,
                                device="cpu", **kw)
        assert {m: {b: r.as_dict() for b, r in rb.items()}
                for m, rb in got.items()} == plain
    with live(cpu_service(tmp_path / "d")) as url:
        got = trunner.run_suite(benches=("BFS", "NW"), n_threads=N_THREADS,
                                service_url=url, parallel=True)
    assert {m: {b: r.as_dict() for b, r in rb.items()}
            for m, rb in got.items()} == plain
    with pytest.raises(Exception):
        trunner.run_suite(benches=("BFS",), n_threads=N_THREADS,
                          service_url="http://127.0.0.1:9")


# ---------------------------------------------------------- sweep bench


def _reference_bench():
    path = os.path.join(REPO, "benchmarks", "sweep_bench.py")
    spec = importlib.util.spec_from_file_location("reference_sweep_bench",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The reference's rows that name its Pallas engine; cold_native stands
# where cold_pallas does.
PALLAS_ROWS = ("sweep/cold_pallas", "sweep/pallas_engine",
               "sweep/pallas_family_launches")
PORT_ROWS = ("sweep/cold_native", "sweep/pool_start",
             "sweep/pool_torch_workers", "sweep/cold_speedup_vs_native",
             "sweep/cold_family_launches", "sweep/warm_family_launches")


def test_sweep_bench_quick_rows_and_counters():
    rbench = _reference_bench()
    assert tsweep_bench.effective_floors(True) == rbench.effective_floors(
        True)
    assert tsweep_bench.effective_floors(False, 3.0, None, 9.0) == \
        rbench.effective_floors(False, 3.0, None, 9.0)
    for low in ((0.0,), (None, 1.0), (None, None, 2.9)):
        with pytest.raises(ValueError, match="may only be raised"):
            tsweep_bench.effective_floors(True, *low)
    rows = tsweep_bench.run(quick=True, device="cpu")
    names = [n for n, _us, _d in rows]
    ref_names = ["sweep/serial_event", "sweep/cold_pr1", "sweep/cold_pr2",
                 "sweep/trace_build", "sweep/cold", "sweep/warm",
                 "sweep/cold_pallas", "sweep/cold_speedup_vs_pr1",
                 "sweep/cold_speedup_vs_pr2", "sweep/native_engine",
                 "sweep/pallas_engine", "sweep/pallas_family_launches",
                 "sweep/cold_cells", "sweep/cold_cache_misses",
                 "sweep/cold_trace_families", "sweep/cold_traces_shared",
                 "sweep/cold_expansion_groups",
                 "sweep/cold_expansions_saved", "sweep/warm_cache_hits",
                 "sweep/warm_cache_misses"]
    assert set(names) == (set(ref_names) - set(PALLAS_ROWS)) | set(
        PORT_ROWS)
    assert len(names) == len(set(names))
    by = {n: (us, d) for n, us, d in rows}
    for name in ("serial_event", "cold_pr1", "cold_pr2", "cold",
                 "cold_native", "pool_start"):
        assert by[f"sweep/{name}"][0] > 0, name
    assert by["sweep/native_engine"][1] == 1.0
    assert by["sweep/pool_torch_workers"][1] == 0.0
    spec = rsweep.SweepSpec(machines=rmachines.paper_suite(),
                            benches=rbench.QUICK_BENCHES,
                            n_threads=rbench.QUICK_N_THREADS)
    root = tempfile.mkdtemp(prefix="ref-sweep-bench-")
    try:
        caches = dict(trace_cache=rsweep.TraceCache(),
                      expansion_cache=rsweep.ExpansionCache())
        _, cold = rsweep.run_sweep_with_stats(
            spec, cache=rsweep.ResultCache(root), **caches)
        _, warm = rsweep.run_sweep_with_stats(
            spec, cache=rsweep.ResultCache(root), **caches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in ("cells", "cache_misses", "trace_families", "traces_shared",
              "expansion_groups", "expansions_saved"):
        assert by[f"sweep/cold_{k}"] == (0.0, float(cold[k])), k
    for k in ("cache_hits", "cache_misses"):
        assert by[f"sweep/warm_{k}"] == (0.0, float(warm[k])), k


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_host_engines_on_card_host_match_card(card):
    """The quick grid through K2 on the card, then through each host
    engine and the pool in this process (which now holds a CUDA
    context): the same records, bit for bit, and no K2 launch."""
    study = tapi.Study(machines=tmachines.paper_suite(),
                       benches=QUICK["benches"], n_threads=512)
    _cuda.reset_launch_counts()
    want = tapi.Session(device=card).run(study)
    torch.cuda.synchronize()
    assert _cuda.launch_count("ws_family_kernel") == 4
    want = [dataclasses.asdict(r.result) for r in want.records]
    runs = [(e, tapi.InProcessBackend(parallel=False)) for e in HOST]
    runs.append(("native", tapi.InProcessBackend(parallel=True,
                                                 max_workers=2)))
    for engine, backend in runs:
        _cuda.reset_launch_counts()
        got = tapi.Session(device=card, backend=backend).run(
            dataclasses.replace(study, engine=engine))
        assert _cuda.launch_count("ws_family_kernel") == 0
        assert [dataclasses.asdict(r.result) for r in got.records] == want
