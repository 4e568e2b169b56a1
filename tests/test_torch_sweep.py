"""The port's study path beyond the paper grid, held against the reference.

* The C aggregation core (``_native.run_aggregation``) gives the columns
  of the reference's C core and of the port's numpy pass, exactly.
* Caches: ``cell_key`` equals the reference's on every cell of the paper,
  dense and Fig. 1 grids; a ``ResultCache`` or ``TraceCache`` snapshot
  written by either package is read by the other; a warm session
  simulates nothing; ``Session.cell`` equals the grid's record.
* The sweep: one family launch per trace family, launches read after the
  next family's launch on the CPU and through a window of pending
  launches on a card, the reference's result shapes and stats keys,
  ``spec_to_dict``/``Study.to_dict`` in the reference's JSON.
* The entry points: ``runner``, the figures, ``python -m
  repro_torch.core.warpsim --dense --cache-dir``.
* The reference grid files of the dense sweep and Fig. 1's SIMD sweeps
  are current. ``gpu``-marked tests run both sweeps and a warm cache on a
  card and skip without one:
  ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_sweep.py``.

Regenerate the grid files with
``PYTHONPATH=src:tests python tests/test_torch_sweep.py --write-grids``.
"""

import dataclasses
import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.core.warpsim import api as rapi
from repro.core.warpsim import divergence as rdiv
from repro.core.warpsim import machines as rmachines
from repro.core.warpsim import runner as rrunner
from repro.core.warpsim import sweep as rsweep
from repro.core.warpsim.trace import BENCHMARKS, get_workload
from repro_torch.benchmarks import figs as tfigs
from repro_torch.configs import paper_gpu as tpaper_gpu
from repro_torch.core.warpsim import __main__ as tmain
from repro_torch.core.warpsim import _cuda, _native
from repro_torch.core.warpsim import api as tapi
from repro_torch.core.warpsim import convert
from repro_torch.core.warpsim import divergence as tdiv
from repro_torch.core.warpsim import machines as tmachines
from repro_torch.core.warpsim import obs as tobs
from repro_torch.core.warpsim import runner as trunner
from repro_torch.core.warpsim import sweep as tsweep
from repro_torch.core.warpsim import timing as ttiming
from repro_torch.core.warpsim import trace as ttrace
from test_golden import GOLDEN_BENCHES, N_THREADS
from test_torch_warpsim import _encode_result, _port_cfg

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "core", "warpsim", "data")


def _asdicts(records):
    return [dataclasses.asdict(r) for r in records]


def _ref_session():
    return rapi.Session(backend=rapi.InProcessBackend(parallel=False))


# ----------------------------------------------- the C aggregation core


def _aggregation_cases():
    """(bench, n_threads, machine set): the paper grid at its sizes, the
    dense sweep's ends at 256 threads, Fig. 1's wider SIMD widths."""
    suite = list(rmachines.paper_suite().values())
    cases = [(b, None, "paper", suite) for b in BENCHMARKS]
    ends = [rmachines.baseline(4), rmachines.baseline(128)]
    simd = (list(rmachines.warp_size_sweep(16).values())
            + list(rmachines.warp_size_sweep(32).values()))
    for b in GOLDEN_BENCHES + ("MTM",):
        cases.append((b, 256, "ws4_ws128", ends))
        cases.append((b, None, "simd16_simd32", simd))
    return cases


@pytest.mark.parametrize(
    "bench,n_threads,cfgs",
    [(b, n, c) for b, n, _name, c in _aggregation_cases()],
    ids=[f"{b}-{n}-{name}" for b, n, name, _c in _aggregation_cases()])
def test_native_aggregation_matches_reference_and_numpy(bench, n_threads,
                                                        cfgs):
    ref_tr = rdiv.build_thread_trace(get_workload(bench, n_threads=n_threads))
    port_tr = tdiv.build_thread_trace(
        ttrace.get_workload(bench, n_threads=n_threads))
    for cfg in cfgs:
        want = rdiv.aggregate_stream(ref_tr, cfg, impl="native")
        pcfg = _port_cfg(cfg)
        for impl in ("native", "python"):
            got = tdiv.aggregate_stream(port_tr, pcfg, impl=impl)
            assert got.n_warps == want.n_warps
            for f in convert.FIELDS:
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), (
                    cfg.name, impl, f)


def test_aggregation_impl_is_checked():
    tr = tdiv.build_thread_trace(ttrace.get_workload("BFS", n_threads=64))
    with pytest.raises(ValueError, match="unknown aggregation impl"):
        tdiv.aggregate_stream(tr, tmachines.baseline(8), impl="auto")


def test_failed_cc_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_cc", lambda: shutil.which("false"))
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="cc failed"):
        _native.build()
    tr = tdiv.build_thread_trace(ttrace.get_workload("BFS", n_threads=64))
    with pytest.raises(RuntimeError, match="cc failed"):
        tdiv.aggregate_stream(tr, tmachines.baseline(8))
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------------ cache keys


def _key_specs():
    """The paper grid (seeds 0-2), the dense sweep and Fig. 1's three
    SIMD sweeps, in both packages."""
    out = [(rsweep.SweepSpec(seeds=(0, 1, 2)),
            tsweep.SweepSpec(seeds=(0, 1, 2))),
           (rsweep.SweepSpec.warp_size_range(4, 128),
            tsweep.SweepSpec.warp_size_range(4, 128))]
    for simd in (8, 16, 32):
        out.append(
            (rsweep.SweepSpec(machines=rmachines.warp_size_sweep(simd)),
             tsweep.SweepSpec(machines=tmachines.warp_size_sweep(simd))))
    return out


@pytest.mark.parametrize("i", range(5),
                         ids=["paper", "dense", "simd8", "simd16", "simd32"])
def test_cell_key_matches_reference(i):
    rspec, tspec = _key_specs()[i]
    rcells, tcells = rspec.cells(), tspec.cells()
    assert len(rcells) == len(tcells) > 0
    for (rm, rcfg, rb, rn, rs), (tm, tcfg, tb, tn, ts) in zip(rcells, tcells):
        assert (rm, rb, rn, rs) == (tm, tb, tn, ts)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert list(dataclasses.asdict(tcfg)) == list(
            dataclasses.asdict(rcfg))
        assert tsweep.cell_key(tb, tcfg, tn, ts) == rsweep.cell_key(
            rb, rcfg, rn, rs)
        assert tsweep.machine_key(tcfg) == rsweep.machine_key(rcfg)
        assert tcfg.expansion_key() == rcfg.expansion_key()


def test_keys_and_presets_match_reference():
    assert tsweep.MODEL_VERSION == rsweep.MODEL_VERSION
    assert tsweep.TRACE_VERSION == rsweep.TRACE_VERSION
    assert ttrace.TRACE_FIELDS == rsweep._TRACE_FIELDS
    for b in ("BFS", "mtm"):
        assert tsweep.trace_key(b, 2048, 2) == rsweep.trace_key(b, 2048, 2)
    # A cell with the bench's default thread count is the cell asking for
    # that count explicitly.
    cfg = tmachines.sw_plus()
    assert tsweep.cell_key("BFS", cfg, None, 0) == tsweep.cell_key(
        "bfs", cfg, 2048, 0)
    for simd in (8, 16, 32):
        assert {k: dataclasses.asdict(v) for k, v in
                tmachines.warp_size_sweep(simd).items()} == {
            k: dataclasses.asdict(v) for k, v in
            rmachines.warp_size_sweep(simd).items()}
    for t, r in ((tmachines.paper_suite(), rmachines.paper_suite()),
                 (tmachines.warp_size_sweep(16),
                  rmachines.warp_size_sweep(16))):
        assert tmachines.sharing_plan(t) == rmachines.sharing_plan(r)
    from repro.configs import paper_gpu as rpaper_gpu
    assert dataclasses.asdict(tpaper_gpu.TABLE1) == dataclasses.asdict(
        rpaper_gpu.TABLE1)
    for name in ("SW+", "LW+", "ws4", "ws128"):
        assert dataclasses.asdict(tapi.resolve_machine_name(name)) == \
            dataclasses.asdict(rapi.resolve_machine_name(name))
    with pytest.raises(ValueError, match="unknown machine"):
        tapi.resolve_machine_name("ws")


# ------------------------------------------------------ shared caches


def _small_study(pkg, **kw):
    return pkg.Study(benches=GOLDEN_BENCHES, n_threads=N_THREADS, **kw)


def test_result_cache_shared_with_reference(tmp_path):
    """A cache the reference wrote serves the port (0 cells simulated),
    and the reverse, with the same records."""
    ref = _ref_session().run(_small_study(rapi))
    want = _asdicts(ref.records)
    rdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rapi.Session(cache_dir=rdir,
                 backend=rapi.InProcessBackend(parallel=False)).run(
        _small_study(rapi))
    got = tapi.Session(device="cpu", cache_dir=rdir).run(_small_study(tapi))
    assert got.stats["simulated"] == 0 and got.stats["cache_hits"] == 30
    assert got.stats["family_launches"] == 0
    assert _asdicts(got.records) == want
    tapi.Session(device="cpu", cache_dir=tdir).run(_small_study(tapi))
    back = rapi.Session(cache_dir=tdir,
                        backend=rapi.InProcessBackend(parallel=False)).run(
        _small_study(rapi))
    assert back.stats["simulated"] == 0
    assert _asdicts(back.records) == want
    # One cell read back through cell_key from the port's files.
    cache = tsweep.ResultCache(tdir)
    cfg = tmachines.sw_plus()
    hit = cache.get(tsweep.cell_key("BFS", cfg, N_THREADS, 0))
    assert dataclasses.asdict(hit) == dataclasses.asdict(
        ref.by(machine="SW+", bench="BFS").one())
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(rdir))


def test_result_cache_quarantines_corrupt_and_adopts(tmp_path):
    cache = tsweep.ResultCache(str(tmp_path))
    res = tsweep.compute_cell("DYN", tmachines.baseline(8), n_threads=64,
                              device="cpu")
    cache.put("a" * 64, res)
    assert cache.count() == 1
    (tmp_path / ("b" * 64 + ".json")).write_text("{not json")
    assert cache.get("b" * 64) is None
    assert cache.corrupt == 1 and cache.adopted == 1
    assert (tmp_path / ("b" * 64 + ".json.corrupt")).exists()
    assert dataclasses.asdict(cache.get("a" * 64)) == dataclasses.asdict(res)
    assert (cache.hits, cache.misses) == (1, 1)
    assert cache.refresh() == 1


def test_trace_snapshot_shared_with_reference(tmp_path):
    """A ThreadTrace snapshot either package writes, the other loads (a
    disk hit, no build), with equal arrays."""
    for bench, writer in (("BFS", "ref"), ("MTM", "port")):
        root = str(tmp_path / writer)
        rwl = get_workload(bench, n_threads=N_THREADS, seed=1)
        twl = ttrace.get_workload(bench, n_threads=N_THREADS, seed=1)
        if writer == "ref":
            want = rsweep.TraceCache().get(rwl, root=root)
            reader = tsweep.TraceCache()
            got = reader.get(twl, root=root)
        else:
            want = tsweep.TraceCache().get(twl, root=root)
            reader = rsweep.TraceCache()
            got = reader.get(rwl, root=root)
        assert (reader.disk_hits, reader.builds) == (1, 0)
        assert got.n_threads == want.n_threads
        for f in ttrace.TRACE_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert os.listdir(root) == [
            rsweep.trace_key(bench, N_THREADS, 1) + ".npz"]


def test_warm_session_simulates_nothing(tmp_path):
    cold = tapi.Session(device="cpu", cache_dir=str(tmp_path),
                        persist_traces=True)
    first = cold.run(_small_study(tapi, seeds=(0, 1)))
    assert first.stats["simulated"] == 60
    assert first.stats["family_launches"] == 10
    assert len(os.listdir(tmp_path / "traces")) == 10
    warm = tapi.Session(device="cpu", cache_dir=str(tmp_path))
    second = warm.run(_small_study(tapi, seeds=(0, 1)))
    assert (second.stats["simulated"], second.stats["family_launches"],
            second.stats["cache_hits"]) == (0, 0, 60)
    assert _asdicts(second.records) == _asdicts(first.records)
    st = warm.cache_stats()
    assert st["result_cache"]["hits"] == 60
    assert st["result_cache"]["entries"] == 60
    assert st["trace_cache"]["builds"] == 0
    # A new machine on a warm trace directory loads the traces from disk.
    third = tapi.Session(device="cpu", cache_dir=str(tmp_path),
                         persist_traces=True).run(_small_study(
                             tapi, machines={"ws4": tmachines.baseline(4)}))
    assert third.stats["trace_disk_hits"] == 5
    assert third.stats["simulated"] == 5


def test_session_cell_matches_grid_record(tmp_path):
    ref = _ref_session().run(_small_study(rapi))
    session = tapi.Session(device="cpu", cache_dir=str(tmp_path))
    for machine in ("SW+", "ws64", tmachines.lw_plus()):
        got = session.cell("BFS", machine, n_threads=N_THREADS)
        name = machine if isinstance(machine, str) else machine.name
        assert dataclasses.asdict(got) == dataclasses.asdict(
            ref.by(machine=name, bench="BFS").one())
    assert session.cache_stats()["result_cache"]["entries"] == 3
    again = session.cell("BFS", "SW+", n_threads=N_THREADS)
    assert session.result_cache.hits == 1
    assert dataclasses.asdict(again) == dataclasses.asdict(
        ref.by(machine="SW+", bench="BFS").one())


# ------------------------------------------------------------- the sweep


def _plain(grid, multi):
    """A run_sweep result as nested dicts of plain fields."""
    if multi:
        return {s: _plain(g, False) for s, g in grid.items()}
    return {m: {b: dataclasses.asdict(r) for b, r in rb.items()}
            for m, rb in grid.items()}


def test_pipelined_sweep_matches_serial(monkeypatch):
    """Each family is read after the next one is launched (two in flight
    at most), one launch a family, and the records equal those of a
    serial run of the same families and of the reference."""
    events = []
    launches = []
    launch, collect = _cuda.launch_family, _cuda.collect

    def traced_launch(pairs, *a, **kw):
        launches.append(launch(pairs, *a, **kw))
        events.append(("launch", len(launches) - 1))
        return launches[-1]

    def traced_collect(lnch):
        events.append(("collect", next(i for i, x in enumerate(launches)
                                       if x is lnch)))
        return collect(lnch)

    monkeypatch.setattr(_cuda, "launch_family", traced_launch)
    monkeypatch.setattr(_cuda, "collect", traced_collect)
    spec = tsweep.SweepSpec(benches=GOLDEN_BENCHES, n_threads=N_THREADS,
                            seeds=(0, 1))
    results, stats = tsweep.run_sweep_with_stats(spec, device="cpu")
    monkeypatch.undo()
    n = stats["trace_families"]
    assert n == 10 and stats["family_launches"] == n == len(launches)
    assert events == [("launch", 0)] + [
        e for k in range(1, n)
        for e in (("launch", k), ("collect", k - 1))] + [("collect", n - 1)]
    # Serial: each family launched and read at once.
    serial = {}
    for seed in spec.seeds:
        for bench in spec.benches:
            wl = ttrace.get_workload(bench, n_threads=N_THREADS, seed=seed)
            tr = tdiv.build_thread_trace(wl)
            pairs = [(tdiv.aggregate_stream(tr, cfg), cfg)
                     for cfg in spec.machine_set().values()]
            for (stream, cfg), raw in zip(pairs, _cuda.run_family(
                    pairs, device="cpu")):
                serial.setdefault(seed, {}).setdefault(cfg.name, {})[
                    bench] = ttiming.loop_result(
                        wl.name, cfg, raw, ttiming.stream_totals(stream))
    assert _plain(results, True) == _plain(serial, True)
    ref, _ = rsweep.run_sweep_with_stats(
        rsweep.SweepSpec(benches=GOLDEN_BENCHES, n_threads=N_THREADS,
                         seeds=(0, 1)), parallel=False)
    assert _plain(results, True) == _plain(ref, True)


class _KeepOrder(tsweep.ResultCache):
    """A ResultCache that keeps the order of its writes."""

    def __init__(self, root):
        super().__init__(root)
        self.order = []

    def put(self, key, result):
        self.order.append(key)
        super().put(key, result)


def _cache_files(root) -> dict:
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


class _Card:
    """``launch_family``, ``collect`` and ``launch_streams`` of a card with
    `sms` SMs whose launches finish `lag` launches after they are made (or
    only when read, with `lag` None); the work itself runs on the CPU."""

    def __init__(self, sms, lag, launch, collect):
        self.sms, self.lag = sms, lag
        self._launch, self._collect = launch, collect
        self.made = 0
        self.events = []        # ("launch", i) and ("collect", i)
        self.most_pending = 0

    def launch_streams(self, device):
        return [None] * _cuda.K2_STREAMS, self.sms

    def launch_family(self, pairs, device, engine, family=None):
        launch = _CardLaunch(self, self.made,
                             self._launch(pairs, "cpu", engine, family=family))
        self.made += 1
        self.events.append(("launch", launch.index))
        read = sum(e == "collect" for e, _ in self.events)
        self.most_pending = max(self.most_pending, self.made - read)
        return launch

    def collect(self, launch):
        self.events.append(("collect", launch.index))
        return self._collect(launch.real)


class _CardLaunch:
    def __init__(self, card, index, real):
        self.card, self.index, self.real = card, index, real
        self.family = real.family

    def finished(self):
        lag = self.card.lag
        return lag is not None and self.card.made - self.index > lag


def _window_events(n, window, early):
    """Launches and reads of `n` families through a window of `window`
    launches: read when the window is full, or (`early`) as soon as the
    next launch is made."""
    if early and window > 1:
        return [("launch", 0)] + [
            e for k in range(1, n)
            for e in (("launch", k), ("collect", k - 1))] + [
            ("collect", n - 1)]
    out = []
    for k in range(n):
        if k >= window:
            out.append(("collect", k - window))
        out.append(("launch", k))
    return out + [("collect", k) for k in range(max(0, n - window), n)]


@pytest.mark.parametrize("sms,streams,lag,window", [
    (132, 8, None, 8), (18, 8, None, 3), (12, 8, None, 2), (6, 8, None, 1),
    (4, 8, None, 1), (132, 2, None, 2), (132, 8, 1, 8), (18, 8, 1, 3)],
    ids=["pool", "sms_over_units", "two_fit", "one_fits", "wider_than_card",
         "pool_of_two", "early_reads", "early_reads_sms"])
def test_family_window_reads_in_launch_order_within_its_depth(
        tmp_path, monkeypatch, sms, streams, lag, window):
    """The family loop on a card of `sms` SMs, with a pool of `streams`:
    launches of 6 units stay within ``min(streams, sms // 6)`` pending (one
    at a time when a family is wider than the card), are read oldest
    first, early once finished, and all by the study's end; records and
    ResultCache writes equal those of the serial loop on the CPU."""
    spec = tsweep.SweepSpec(benches=GOLDEN_BENCHES, n_threads=128,
                            seeds=(0, 1, 2))
    monkeypatch.setattr(_cuda, "K2_STREAMS", 1)
    serial_cache = _KeepOrder(str(tmp_path / "serial"))
    serial, serial_stats = tsweep.run_sweep_with_stats(
        spec, device="cpu", cache=serial_cache)
    n = serial_stats["family_launches"]
    assert n == 15
    monkeypatch.setattr(_cuda, "K2_STREAMS", streams)
    card = _Card(sms, lag, _cuda.launch_family, _cuda.collect)
    for name in ("launch_streams", "launch_family", "collect"):
        monkeypatch.setattr(_cuda, name, getattr(card, name))
    cache = _KeepOrder(str(tmp_path / "window"))
    results, stats = tsweep.run_sweep_with_stats(spec, device="cpu",
                                                 cache=cache)
    assert stats["family_launches"] == n
    assert card.events == _window_events(n, window, lag is not None)
    assert card.most_pending == (2 if lag is not None and window > 1
                                 else window)
    assert _plain(results, True) == _plain(serial, True)
    assert cache.order == serial_cache.order and len(cache.order) == 90
    assert _cache_files(cache.root) == _cache_files(serial_cache.root)


# ------------------------------------------ the study loop's stages


def _stage_counts() -> dict:
    """Observations of each stage in the default domain so far."""
    snap = tobs.default().registry.snapshot().get("warpsim_stage_seconds",
                                                  {})
    return {k[len('{stage="'):-len('"}.count')]: int(v)
            for k, v in snap.items() if k.endswith(".count")}


LOOP_STAGES = ("study", "result_lookup", "plan", "marshal", "launch",
               "wait", "scatter")


def _loop_study(seed):
    return tapi.Study(benches=GOLDEN_BENCHES[:2], n_threads=N_THREADS,
                      seeds=(seed,), engine="torch")


def test_study_stages_count_once_a_launch_and_once_a_study(tmp_path):
    """``marshal``, ``launch``, ``wait`` and ``scatter`` are observed once a
    family launch; ``study``, ``plan`` and ``result_lookup`` once a
    ``Session.run`` (a warm one included, which launches nothing)."""
    session = tapi.Session(device="cpu", cache_dir=str(tmp_path))
    before = _stage_counts()
    cold = session.run(_loop_study(0))
    warm = session.run(_loop_study(0))
    after = _stage_counts()
    got = {k: after.get(k, 0) - before.get(k, 0) for k in LOOP_STAGES}
    n = cold.stats["family_launches"]
    assert n == 2 and warm.stats["family_launches"] == 0
    assert got == {"study": 2, "result_lookup": 2, "plan": 2, "marshal": n,
                   "launch": n, "wait": n, "scatter": n}


def test_study_root_is_one_span_with_the_loops_stages_under_it():
    ob = tobs.Observability()
    with tobs.start_trace("study", obs=ob) as ctx:
        tsweep.run_sweep_with_stats(_loop_study(1).to_spec(),
                                    engine="torch", device="cpu")
    spans = ob.spans.dump(ctx.trace_id)
    names = [s["name"] for s in spans]
    assert names.count("study") == 1
    root = next(s for s in spans if s["name"] == "study")
    assert root["parent"] is None
    for name in ("plan", "marshal", "launch", "wait", "scatter"):
        assert all(s["parent"] == root["span"] for s in spans
                   if s["name"] == name), name
    launch = next(s for s in spans if s["name"] == "launch")
    assert launch["attrs"]["family"].split("/")[0] in GOLDEN_BENCHES[:2]
    assert launch["attrs"]["units"] == 6
    snap = ob.registry.snapshot()["warpsim_stage_seconds"]
    assert snap['{stage="study"}.count'] == 1


def _user_annotations(prof, path) -> list:
    prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def test_stages_mark_the_profilers_trace_only_while_it_records(
        tmp_path, monkeypatch):
    """Under torch.profiler the study's root and stages are user
    annotations in its trace (the root once); outside it no
    ``record_function`` is made."""
    from torch.profiler import ProfilerActivity, profile
    made = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kw):
        made.append(name)
        return real(name, *args, **kw)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    session = tapi.Session(device="cpu")
    session.run(_loop_study(2))
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = session.run(_loop_study(3))
    names = _user_annotations(prof, tmp_path / "trace.json")
    n = res.stats["family_launches"]
    assert names.count("study") == 1
    for name in ("marshal", "launch", "wait", "scatter"):
        assert names.count(name) == n, name
    assert names.count("plan") == 1 and "aggregate" in names
    assert sorted(made) == sorted(names)


def test_collect_reads_k2s_events_into_its_families():
    """The timing events of a launch are read after its wait, into the
    ambient domain's ``warpsim_k2_seconds`` and ``warpsim_k2_steps_total``
    by placement."""
    class Event:
        def elapsed_time(self, end):
            return 2.5          # ms

    ob = tobs.Observability()
    wl = ttrace.get_workload("BFS", n_threads=N_THREADS, seed=0)
    stream = tdiv.expand_stream(wl, tmachines.baseline(8))
    launch = _cuda.launch_family([(stream, tmachines.baseline(8))],
                                 device="cpu", family="BFS/128/0")
    assert launch.k2 is None and launch.family == "BFS/128/0"
    launch.k2 = _cuda.K2Timing(Event(), Event(), "shared", 40)
    want = _cuda.collect(dataclasses.replace(launch, k2=None))
    with tobs.bind(ob):
        assert _cuda.collect(launch) == want
    snap = ob.registry.snapshot()
    assert snap["warpsim_k2_seconds"] == {
        '{placement="shared"}.sum': 0.0025,
        '{placement="shared"}.count': 1}
    assert snap["warpsim_k2_steps_total"] == {'{placement="shared"}': 40}


@pytest.mark.parametrize("seeds", [(0,), (1, 2)], ids=["one", "two"])
def test_run_sweep_shape_and_stats_match_reference(seeds):
    rspec = rsweep.SweepSpec(benches=("BFS", "DYN"), n_threads=N_THREADS,
                             seeds=seeds)
    tspec = tsweep.SweepSpec(benches=("BFS", "DYN"), n_threads=N_THREADS,
                             seeds=seeds)
    want, rstats = rsweep.run_sweep_with_stats(
        rspec, parallel=False, trace_cache=rsweep.TraceCache(),
        expansion_cache=rsweep.ExpansionCache())
    got, tstats = tsweep.run_sweep_with_stats(tspec, device="cpu")
    assert set(tstats) == set(rstats)
    assert {k: v for k, v in tstats.items() if k != "family_launches"} == \
        {k: v for k, v in rstats.items() if k != "family_launches"}

    assert _plain(got, len(seeds) > 1) == _plain(want, len(seeds) > 1)
    assert list(got) == list(want)
    assert tsweep.run_sweep(tspec, device="cpu").keys() == got.keys()
    recs = tapi.records_from_grid(tspec, got)
    assert _asdicts(recs) == _asdicts(rapi.records_from_grid(rspec, want))


def test_spec_and_study_dicts_match_reference():
    cases = [
        (rapi.Study(), tapi.Study()),
        (rapi.Study(seeds=(0, 2), benches=("BFS",), n_threads=256),
         tapi.Study(seeds=(0, 2), benches=("BFS",), n_threads=256)),
        (rapi.Study.warp_size_range(4, 128, engine="auto"),
         tapi.Study.warp_size_range(4, 128)),
        (rapi.Study(machines=rmachines.warp_size_sweep(16)),
         tapi.Study(machines=tmachines.warp_size_sweep(16))),
        (rapi.Study(benches=(), seeds=()), tapi.Study(benches=(), seeds=())),
    ]
    for ref, port in cases:
        d = port.to_dict()
        assert json.dumps(d, sort_keys=True) == json.dumps(ref.to_dict(),
                                                           sort_keys=True)
        assert tapi.Study.from_dict(json.loads(json.dumps(d))) == port
        assert tapi.Study.from_dict(ref.to_dict()).to_dict() == d
        spec = port.to_spec()
        assert tsweep.spec_from_dict(tsweep.spec_to_dict(spec)) == spec
        assert tsweep.spec_to_dict(spec) == rsweep.spec_to_dict(ref.to_spec())
        assert tapi.Study.from_spec(spec) == dataclasses.replace(
            port, engine="auto")
        assert [c[:1] + c[2:] for c in port.cells()] == [
            c[:1] + c[2:] for c in ref.cells()]
    assert tsweep.spec_from_dict({}) == tsweep.SweepSpec()


def test_study_result_accessors_and_wire():
    got = tapi.Session(device="cpu").run(_small_study(tapi, seeds=(0, 1)))
    ref = _ref_session().run(_small_study(rapi, seeds=(0, 1)))
    assert got.machines == ref.machines and got.benches == ref.benches
    assert got.seeds == (0, 1)
    assert [r.to_wire() for r in got] == [r.to_wire() for r in ref]
    blob = json.loads(json.dumps(got.to_json()))
    back = tapi.StudyResult.from_json(blob)
    assert _asdicts(back.records) == _asdicts(got.records)
    assert back.stats == got.stats and back.backend == "inprocess"
    one = got.by(machine="LW+", bench="DYN", seed=1).one()
    assert dataclasses.asdict(one) == dataclasses.asdict(
        ref.by(machine="LW+", bench="DYN", seed=1).one())
    with pytest.raises(ValueError, match="exactly one"):
        got.by(machine="LW+").one()
    single = got.by(seed=0)
    assert list(single.legacy_grid()) == list(got.machines)
    assert list(got.legacy_grid()) == [0, 1]
    assert single.summary() == ref.by(seed=0).summary()


def test_runner_entry_points_match_reference(tmp_path):
    cfg = rmachines.baseline(16)
    got = trunner.run_one("NW", _port_cfg(cfg), n_threads=N_THREADS,
                          device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(
        rrunner.run_one("NW", cfg, n_threads=N_THREADS))
    grid = trunner.run_suite(benches=("BFS", "NW"), n_threads=N_THREADS,
                             device="cpu")
    want = rrunner.run_suite(benches=("BFS", "NW"), n_threads=N_THREADS,
                             parallel=False)
    assert {m: {b: r.as_dict() for b, r in rb.items()}
            for m, rb in grid.items()} == {
        m: {b: r.as_dict() for b, r in rb.items()}
        for m, rb in want.items()}
    tpath, rpath = str(tmp_path / "t" / "s.json"), str(tmp_path / "r.json")
    trunner.save_results(grid, tpath)
    rrunner.save_results(want, rpath)
    with open(tpath) as a, open(rpath) as b:
        assert json.load(a) == json.load(b)


# -------------------------------------------------------- the entry points


def test_figures_match_reference_records(tmp_path):
    """fig1 (the SIMD sweeps) and fig7 (the paper grid and its bands) on
    the CPU, against the same formulas over the reference's records."""
    figs = tfigs.Figures(tapi.Session(device="cpu",
                                      cache_dir=str(tmp_path / "cache")),
                         str(tmp_path / "out"))
    ref = _ref_session()
    rows = {n: v for n, _us, v in figs.fig1_warpsize_simd()}
    base = rrunner.mean_ipc(ref.run(rapi.Study(
        machines=rmachines.warp_size_sweep(8))).per_bench("simd8_ws32"))
    want = {}
    for simd in (8, 16, 32):
        res = ref.run(rapi.Study(machines=rmachines.warp_size_sweep(simd)))
        for m in res.machines:
            want[f"fig1/{m}"] = rrunner.mean_ipc(res.per_bench(m)) / base
    assert rows == want
    rows = {n: v for n, _us, v in figs.fig7_swlw_perf()}
    suite = ref.run(rapi.Study())
    for k, v in suite.summary().items():
        assert rows[f"fig7/summary/{k}"] == v
    for k, band in ref.run(rapi.Study(seeds=tfigs.BAND_SEEDS)).bands().items():
        for stat in ("mean", "min", "max"):
            assert rows[f"fig7/band/{k}/{stat}"] == band[stat]
    assert rows["fig7/SW+/BFS"] == suite.by(machine="SW+",
                                            bench="BFS").one().ipc
    assert sorted(os.listdir(tmp_path / "out")) == [
        "fig1_warpsize_simd.json", "fig7_swlw_perf.json"]
    rows = figs.fig2_coalescing() + figs.fig3_idle() + figs.fig4_perf() \
        + figs.fig5_swlw_coalescing() + figs.fig6_swlw_idle()
    assert len(rows) == 60 + 60 + 60 + 12 + 90 + 90
    # The paper grid's 270 cells and the SIMD sweeps' 180, of which
    # simd8's 60 are the paper's ws8..ws64 cells of seed 0.
    assert figs.session.cache_stats()["result_cache"]["entries"] == 390


def test_cli_dense_sweep_with_cache(tmp_path):
    argv = ["--device", "cpu", "--dense", "--cache-dir", str(tmp_path)]
    out = io.StringIO()
    with redirect_stdout(out):
        tmain.main(argv)
    text = out.getvalue()
    assert "6 machines -> 1 thread trace + 5 aggregations per workload" in text
    assert "ws8+SW+ share one expansion" in text
    assert "90 cells in" in text and "90 simulated" in text
    assert "15 family launches" in text
    assert "swplus_over_lwplus" in text
    dense = ref_dense_geomeans()
    for m, v in dense.items():
        assert f"{m:6s} geomean IPC {v:6.3f}" in text
    out = io.StringIO()
    with redirect_stdout(out):
        tmain.main(argv)
    text = out.getvalue()
    assert "(90 cached, 0 simulated" in text
    assert "(90 cached, 0 family launches)" in text


def ref_dense_geomeans():
    res = _ref_session().run(rapi.Study.warp_size_range(4, 128))
    return {m: rrunner.mean_ipc(res.per_bench(m)) for m in res.machines}


# ---------------------------------------------- the reference grid files


def _studies(name):
    if name == "dense":
        return [rapi.Study.warp_size_range(4, 128, engine="native")]
    return [rapi.Study(machines=rmachines.warp_size_sweep(simd),
                       engine="native") for simd in (8, 16, 32)]


GRID_FILES = {"dense": os.path.join(DATA, "dense_grid_seed0.json"),
              "simd": os.path.join(DATA, "simd_grids_seed0.json")}


def sweep_grid_blob(name) -> dict:
    """The reference's records of the dense sweep (ws4..ws128) or of
    Fig. 1's SIMD sweeps (8/16/32 x warp sizes {1,2,4,8} x SIMD width),
    seed 0, default sizes, from its ``native`` engine (floats as
    ``float.hex()``), and the studies that made them."""
    studies = _studies(name)
    records = []
    session = _ref_session()
    for study in studies:
        records += [{"machine": r.machine, "bench": r.bench, "seed": r.seed,
                     "n_threads": r.n_threads,
                     "result": _encode_result(r.result)}
                    for r in session.run(study).records]
    return {"studies": [s.to_dict() for s in studies], "records": records}


def write_grid_files() -> None:
    for name, path in GRID_FILES.items():
        blob = sweep_grid_blob(name)
        lines = ",\n".join(json.dumps(r, sort_keys=True)
                           for r in blob["records"])
        with open(path, "w", encoding="utf-8") as fh:
            # The studies keep their key order: a study's machines run in
            # it, and the records follow.
            fh.write('{"studies": ' + json.dumps(blob["studies"])
                     + ',\n"records": [\n' + lines + "\n]}\n")


@pytest.mark.parametrize("name", sorted(GRID_FILES))
def test_sweep_grid_file_is_current(name):
    with open(GRID_FILES[name], encoding="utf-8") as fh:
        blob = json.load(fh)
    want = sweep_grid_blob(name)
    assert blob == want
    assert json.dumps(blob["studies"]) == json.dumps(want["studies"])
    assert len(blob["records"]) == {"dense": 90, "simd": 180}[name]


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRID_FILES))
def test_sweeps_on_card_match_grid_files(card, name):
    """The dense sweep and the SIMD sweeps on the card: one K2 launch a
    family, every record equal to the reference's file."""
    with open(GRID_FILES[name], encoding="utf-8") as fh:
        blob = json.load(fh)
    session = tapi.Session(device=card)
    _cuda.reset_launch_counts()
    records = []
    for d in blob["studies"]:
        res = session.run(tapi.Study.from_dict(dict(d, engine="cuda")))
        assert res.stats["family_launches"] == 15
        records += res.records
    torch.cuda.synchronize()
    assert _cuda.launch_count("ws_family_kernel") == 15 * len(
        blob["studies"])
    assert [{"machine": r.machine, "bench": r.bench, "seed": r.seed,
             "n_threads": r.n_threads, "result": _encode_result(r.result)}
            for r in records] == blob["records"]


@pytest.mark.gpu
def test_warm_cache_on_card_launches_nothing(card, tmp_path):
    study = tapi.Study(benches=GOLDEN_BENCHES, n_threads=N_THREADS)
    first = tapi.Session(device=card, cache_dir=str(tmp_path)).run(study)
    _cuda.reset_launch_counts()
    second = tapi.Session(device=card, cache_dir=str(tmp_path)).run(study)
    assert second.stats["simulated"] == 0
    assert _cuda.launch_count("ws_family_kernel") == 0
    assert _asdicts(second.records) == _asdicts(first.records)
    cell = tapi.Session(device=card).cell("BFS", "SW+", n_threads=N_THREADS)
    assert dataclasses.asdict(cell) == dataclasses.asdict(
        first.by(machine="SW+", bench="BFS").one())


@pytest.mark.gpu
@pytest.mark.parametrize("obs_on", [True, False], ids=["obs", "no_obs"])
def test_k2_families_count_the_cards_launches_by_placement(card, obs_on,
                                                           monkeypatch):
    """On the card each K2 launch is one observation of its placement's
    ``warpsim_k2_seconds`` and adds its longest unit's ops to
    ``warpsim_k2_steps_total``; with observability off no event is
    recorded and nothing is observed."""
    if not obs_on:
        monkeypatch.setenv(tobs.ENV_OBS, "0")
    ob = tobs.Observability()
    study = tapi.Study(benches=GOLDEN_BENCHES, n_threads=N_THREADS,
                       engine="cuda")
    _cuda.reset_launch_counts()
    with tobs.bind(ob):
        res = tapi.Session(device=card).run(study)
    routes = {p: _cuda.route_count("ws_family_kernel", p)
              for p in _cuda.PLACEMENTS}
    snap = ob.registry.snapshot()
    if not obs_on:
        assert "warpsim_k2_seconds" not in snap
        return
    secs = snap["warpsim_k2_seconds"]
    assert sum(routes.values()) == res.stats["family_launches"]
    for p, n in routes.items():
        assert secs.get(f'{{placement="{p}"}}.count', 0) == n
        if n:
            assert 0 < secs[f'{{placement="{p}"}}.sum'] < 60
            assert snap["warpsim_k2_steps_total"][
                f'{{placement="{p}"}}'] >= n


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-grids"]:
        write_grid_files()
        print(f"wrote {', '.join(GRID_FILES.values())}")
    else:
        sys.exit("usage: python tests/test_torch_sweep.py --write-grids")
