"""The port's sweep service against the reference's, on the CPU.

Port daemons run with ``device="cpu"``, ``engine="torch"`` (the family
kernel's plain version) at 128 threads a cell. Every record is held
against the reference's in-process records bit for bit (every SimResult
field, floats by ``float.hex()``), through the port's clients and the
reference's. Also here: the work queue's leases under an injected clock,
in-flight dedup, warm passes, ``/stats`` against ``/metrics``, the boot
refusal without a card, the thread safety of the kernel libraries'
first use and counters, the facade grid's data file, and (marked
``gpu``) the facade grid served by a daemon on the card.

Regenerate the data file with
``PYTHONPATH=src:tests python tests/test_torch_service.py --write-grid``.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from repro.core.warpsim import api as rapi
from repro.core.warpsim import obs as robs
from repro.core.warpsim import service as rservice
from repro.core.warpsim import sweep as rsweep
from repro.core.warpsim import work_queue as rwq
from repro_torch import _nvcc
from repro_torch.benchmarks import facade_parity
from repro_torch.benchmarks import figs as tfigs
from repro_torch.core.warpsim import _cuda, _native
from repro_torch.core.warpsim import api as tapi
from repro_torch.core.warpsim import machines as tmachines
from repro_torch.core.warpsim import obs as tobs
from repro_torch.core.warpsim import service as tservice
from repro_torch.core.warpsim import work_queue as twq
from repro_torch.kernels import _lib as lm_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_THREADS = 128
FACADE_FILE = str(facade_parity.GRID_FILE)


def small_study(seeds=(0, 1), benches=("BFS", "DYN")) -> tapi.Study:
    """2 benches x ws8 / SW+ / LW+ x `seeds`, 128 threads."""
    return tapi.Study(
        benches=benches,
        machines={"ws8": tmachines.baseline(8), "SW+": tmachines.sw_plus(),
                  "LW+": tmachines.lw_plus()},
        n_threads=N_THREADS, seeds=tuple(seeds))


def ref_study(study) -> rapi.Study:
    """The same study, as the reference's type."""
    return rapi.Study.from_dict(study.to_dict())


def ref_records(study) -> list:
    """The reference's in-process records of `study`, encoded."""
    res = rapi.Session(backend=rapi.InProcessBackend(parallel=False)).run(
        rapi.Study.from_dict(dict(study.to_dict(), engine="native")))
    return encode(res.records)


def encode(records) -> list:
    return [facade_parity.encode_record(r) for r in records]


def cpu_service(root, **kw) -> tservice.SweepService:
    return tservice.SweepService(str(root), engine="torch", device="cpu",
                                 **kw)


@contextlib.contextmanager
def live(svc):
    """`svc` (either package's SweepService) on an ephemeral port."""
    mod = tservice if isinstance(svc, tservice.SweepService) else rservice
    httpd = mod.serve(svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://%s:%d" % httpd.server_address[:2]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return False


# ------------------------------------------------------------ records


def test_port_daemon_records_equal_reference_through_both_clients(tmp_path):
    study = small_study()
    want = ref_records(study)
    with live(cpu_service(tmp_path)) as url:
        port = tapi.Session(device="cpu",
                            backend=tapi.ServiceBackend(url)).run(study)
        ref = rapi.Session(backend=rapi.ServiceBackend(url)).run(
            ref_study(study))
    assert port.backend == "service" and port.stats["simulated"] == 12
    assert encode(port.records) == want
    assert encode(ref.records) == want
    assert ref.stats["cache_hits"] == 12


def test_reference_job_drained_by_port_worker(tmp_path):
    study = small_study(seeds=(2,))
    svc = rservice.SweepService(str(tmp_path), persist_traces=False)
    with live(svc) as url:
        job = rservice.SweepClient(url).enqueue(study.to_spec(),
                                                chunk_size=2)
        n = twq.run_worker(url, job["job"], device="cpu", poll_seconds=0.01)
        assert n == 6
        assert rservice.SweepClient(url).queue_status(
            job["job"])["completed"] == 3
        res = rapi.Session(backend=rapi.ServiceBackend(url)).run(
            ref_study(study))
    assert res.stats["simulated"] == 0
    assert svc.counters["queue_cells_adopted"] == 6
    assert encode(res.records) == ref_records(study)


def test_port_job_drained_by_reference_worker(tmp_path):
    study = small_study(seeds=(3,))
    svc = cpu_service(tmp_path, persist_traces=False)
    with live(svc) as url:
        job = tservice.SweepClient(url).enqueue(study.to_spec(),
                                                chunk_size=4)
        assert rwq.run_worker(url, job["job"], poll_seconds=0.01) == 6
        res = tapi.Session(device="cpu",
                           backend=tapi.ServiceBackend(url)).run(study)
    assert res.stats["simulated"] == 0
    assert svc.counters["queue_cells_adopted"] == 6
    assert encode(res.records) == ref_records(study)


def test_queue_backend_on_port_daemon(tmp_path):
    study = small_study(seeds=(1,))
    with live(cpu_service(tmp_path)) as url:
        res = tapi.Session(device="cpu", backend=tapi.QueueBackend(
            url, chunk_size=2)).run(study)
    assert res.backend == "queue"
    assert res.stats["queue_cells_computed"] == 6
    assert encode(res.records) == ref_records(study)


def test_http_cell_matches_reference(tmp_path):
    with live(cpu_service(tmp_path)) as url:
        port = tservice.SweepClient(url).cell("BFS", "SW+", seed=1,
                                              n_threads=N_THREADS)
        ref = rservice.SweepClient(url).cell("BFS", "SW+", seed=1,
                                             n_threads=N_THREADS)
    cfg = rapi.resolve_machine_name("SW+")
    expect = rsweep.compute_cell("BFS", cfg, n_threads=N_THREADS, seed=1,
                                 engine="native")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref) \
        == dataclasses.asdict(expect)


# ------------------------------------------------------- dedup and cache


def test_concurrent_cold_requests_simulate_once(tmp_path, monkeypatch):
    """The owner is held inside compute_cell until the second requester
    has parked on its in-flight future: one simulation, one dedup wait."""
    svc = cpu_service(tmp_path, persist_traces=False)
    release = threading.Event()
    orig = tservice.compute_cell
    calls = []

    def slow_compute(*args, **kwargs):
        calls.append(threading.current_thread().name)
        assert release.wait(10)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tservice, "compute_cell", slow_compute)
    cfg = tmachines.baseline(8)
    results = {}

    def request(tag):
        results[tag] = svc.cell_with_source("DYN", cfg, N_THREADS, 0)

    t1 = threading.Thread(target=request, args=("a",))
    t1.start()
    assert _wait(lambda: calls)
    t2 = threading.Thread(target=request, args=("b",))
    t2.start()
    assert _wait(lambda: svc.counters["dedup_waits"] == 1)
    release.set()
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert len(calls) == 1
    assert svc.counters["simulated"] == 1
    assert sorted(src for _, src in results.values()) == [
        "dedup", "simulated"]
    assert dataclasses.asdict(results["a"][0]) == dataclasses.asdict(
        results["b"][0])
    res_c, src_c = svc.cell_with_source("DYN", cfg, N_THREADS, 0)
    assert src_c == "cache" and svc.counters["simulated"] == 1


def test_http_concurrent_cold_cells_dedup(tmp_path, monkeypatch):
    """The same over HTTP: two concurrent ``GET /cell`` for one cold cell
    make one simulation and one dedup wait."""
    svc = cpu_service(tmp_path, persist_traces=False)
    release = threading.Event()
    orig = tservice.compute_cell

    def held(*args, **kwargs):
        assert release.wait(10)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tservice, "compute_cell", held)
    with live(svc) as url:
        got = {}

        def fetch(tag):
            got[tag] = twq._http_json(
                url + f"/cell?bench=BFS&machine=SW%2B&seed=3"
                      f"&n_threads={N_THREADS}", timeout=30)

        threads = [threading.Thread(target=fetch, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        assert _wait(lambda: svc.counters["dedup_waits"] == 1)
        release.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    assert svc.counters["simulated"] == 1
    assert sorted(g["source"] for g in got.values()) == ["dedup",
                                                          "simulated"]
    assert got["a"]["result"] == got["b"]["result"]


def test_warm_study_simulates_nothing(tmp_path):
    study = small_study()
    svc = cpu_service(tmp_path)
    with live(svc) as url:
        backend = tapi.ServiceBackend(url)
        cold = tapi.Session(device="cpu", backend=backend).run(study)
        warm = tapi.Session(device="cpu", backend=backend).run(study)
        stats = tservice.SweepClient(url).stats()
    assert cold.stats["simulated"] == 12
    assert warm.stats["simulated"] == 0 and warm.stats["cache_hits"] == 12
    assert stats["counters"]["simulated"] == 12
    assert encode(warm.records) == encode(cold.records)
    # A fresh daemon over the same root (a restart) is warm too.
    with live(cpu_service(tmp_path)) as url:
        again = tapi.Session(device="cpu", backend=tapi.ServiceBackend(
            url)).run(study)
    assert again.stats["simulated"] == 0


def test_stats_and_metrics_agree_in_both_parsers(tmp_path):
    svc = cpu_service(tmp_path)
    with live(svc) as url:
        tapi.Session(device="cpu", backend=tapi.ServiceBackend(url)).run(
            small_study(seeds=(0,)))
        tservice.SweepClient(url).cell("BFS", "ws8", n_threads=N_THREADS)
        text = twq._http_text(url + "/metrics")
        counters = tservice.SweepClient(url).stats()["counters"]
    ours = tobs.parse_exposition(text)
    assert robs.parse_exposition(text) == ours
    for key, (metric, _doc) in tservice._COUNTER_METRICS.items():
        # /stats is one request after the scrape; a counter never bumped
        # has no sample.
        assert ours.get(metric, 0) + (key == "requests") == counters[key], key
    assert counters["simulated"] == 6 and counters["cache_hits"] == 1
    assert ours['warpsim_stage_seconds_count{stage="engine"}'] == 6


def test_metric_and_counter_names_are_the_reference_s():
    assert tservice._COUNTER_METRICS == rservice._COUNTER_METRICS
    assert (tservice._CLIENT_COUNTER_METRICS
            == rservice._CLIENT_COUNTER_METRICS)
    assert tobs.Observability().registry.names() == \
        robs.Observability().registry.names()
    assert tobs.OP_HEADER == robs.OP_HEADER == tservice.OP_HEADER


# ------------------------------------------------------ leases (queue)


def _cells(study):
    return study.cells()


@pytest.mark.parametrize("mod", [twq, rwq], ids=["port", "reference"])
def test_work_queue_requeues_on_worker_death(mod):
    clock = FakeClock()
    q = mod.WorkQueue(_cells(small_study(seeds=(0,), benches=("BFS",))),
                      chunk_size=1, lease_seconds=10, clock=clock)
    dead = q.lease("w-dead")
    assert dead.chunk_id == 0
    assert q.lease("w2").chunk_id == 1
    assert q.lease("w2").chunk_id == 2
    assert q.lease("w2") is None and not q.done
    q.complete(1, "w2")
    q.complete(2, "w2")
    clock.t = 11.0
    reclaimed = q.lease("w2")
    assert reclaimed.chunk_id == 0 and reclaimed.attempts == 2
    assert q.status()["leases_expired"] == 1
    q.complete(0, "w2")
    assert q.done and q.complete(0, "w-dead")
    assert q.status()["stale_completions"] == 0


@pytest.mark.parametrize("mod", [twq, rwq], ids=["port", "reference"])
def test_work_queue_renew_and_stale_completion(mod):
    clock = FakeClock()
    q = mod.WorkQueue(_cells(small_study(seeds=(0,), benches=("BFS",))),
                      chunk_size=3, lease_seconds=10, clock=clock)
    slow = q.lease("w-slow")
    clock.t = 8.0
    assert q.renew(slow.chunk_id, "w-slow")     # extends to t=18
    clock.t = 15.0
    assert q.lease("w2") is None                # still held
    clock.t = 19.0
    again = q.lease("w2")
    assert again.chunk_id == slow.chunk_id
    assert not q.renew(slow.chunk_id, "w-slow")
    assert q.complete(slow.chunk_id, "w-slow")  # the "dead" one returns
    assert q.status()["stale_completions"] == 1 and q.done
    assert q.chunks[0].cells == [] and q.status()["cells"] == 3


def test_work_queue_script_matches_reference():
    """One script of leases, renewals, expiries and completions on both
    packages' queues: the same grants, statuses and snapshots."""
    cells = _cells(small_study())
    clocks = (FakeClock(), FakeClock())
    queues = [mod.WorkQueue(cells, chunk_size=3, lease_seconds=5,
                            clock=clk, trace_id="t1")
              for mod, clk in zip((twq, rwq), clocks)]
    log = [[], []]
    for i, q in enumerate(queues):
        clk = clocks[i]
        for step in range(12):
            clk.t = step * 2.0
            c = q.lease(f"w{step % 3}")
            if c is not None:
                log[i].append(("lease", c.chunk_id, c.attempts,
                               [twq.cell_to_wire(x) for x in c.cells]))
                if step % 3:
                    q.complete(c.chunk_id, f"w{step % 3}")
            log[i].append(("renew", q.renew(0, "w0")))
            log[i].append(("status", q.status()))
        log[i].append(("snapshot", json.dumps(q.to_dict(), sort_keys=True)))
    assert log[0] == log[1]
    restored = twq.WorkQueue.from_dict(json.loads(log[1][-1][1]),
                                       clock=clocks[0])
    assert restored.status() == queues[0].status()


def test_queue_end_to_end_with_worker_death(tmp_path):
    """Two workers drain one job over HTTP; one leases a chunk and dies.
    The daemon's clock is fake: the survivor's poll sleep moves it past
    the dead worker's lease, which expires and requeues."""
    clock = FakeClock()
    svc = cpu_service(tmp_path, persist_traces=False, clock=clock)
    study = small_study(seeds=(0,))
    with live(svc) as url:
        client = tservice.SweepClient(url)
        job = client.enqueue(study.to_spec(), chunk_size=2,
                             lease_seconds=10.0)
        assert job["chunks"] == 3
        dead = twq._http_json(url + f"/queue/lease?job={job['job']}"
                                    f"&worker=w-dead")
        assert dead["chunk"] is not None

        def tick(seconds):
            clock.t += max(seconds, 11.0)

        n = twq.run_worker(url, job["job"], worker_id="w-live",
                           device="cpu", poll_seconds=0.05, sleep=tick)
        assert n == 6
        status = client.queue_status(job["job"])
        assert status["completed"] == 3 and status["leases_expired"] >= 1
    assert svc.counters["queue_cells_adopted"] == 6
    res = svc.study(study)
    assert res.stats["simulated"] == 0 and res.stats["cache_hits"] == 6


# ------------------------------------------------- health and boot


def test_healthz_reports_engine_device_and_libraries(tmp_path):
    with live(cpu_service(tmp_path)) as url:
        health = tservice.SweepClient(url).healthz()
    assert health["ok"] and health["engine"] == "torch"
    assert health["device"] == "cpu"
    assert health["native"]["loaded"] and health["native"]["engine"] == \
        "native"
    assert os.path.exists(health["native"]["library"])
    assert set(health["cuda"]) == {"cuda_available", "library", "launches"}
    assert health["cuda"]["launches"]["ws_family_kernel"] >= 0
    assert "pallas" not in health


def test_engine_must_match_device(tmp_path):
    with pytest.raises(ValueError, match="does not run on device"):
        tservice.SweepService(str(tmp_path), engine="cuda", device="cpu")


def test_daemon_refuses_cuda_without_a_card(tmp_path):
    """Asked for the card on a host without one, the daemon exits
    non-zero at boot; it never serves from the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the daemon would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tservice.SweepService(str(tmp_path), device="cuda")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.warpsim.service",
         "--port", "0", "--cache-dir", str(tmp_path / "c")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "listening" not in proc.stdout


# ------------------------------------------------ Session.from_env, figs


def test_session_from_env_routes_to_a_live_daemon(tmp_path, monkeypatch):
    for var in ("WARPSIM_BACKEND", "WARPSIM_SERVICE_URL",
                "WARPSIM_SERVICE_URLS"):
        monkeypatch.delenv(var, raising=False)
    local = tapi.Session.from_env(cache_dir=str(tmp_path / "l"),
                                  device="cpu")
    assert isinstance(local.backend, tapi.InProcessBackend)
    assert local.result_cache is not None and local.device == "cpu"
    with live(cpu_service(tmp_path / "d")) as url:
        monkeypatch.setenv("WARPSIM_SERVICE_URL", url)
        assert isinstance(tapi.Session.from_env(device="cpu").backend,
                          tapi.ServiceBackend)
        monkeypatch.setenv("WARPSIM_BACKEND", "queue")
        queued = tapi.Session.from_env(device="cpu")
        assert isinstance(queued.backend, tapi.QueueBackend)
        res = queued.run(small_study(seeds=(0,), benches=("DYN",)))
        assert res.stats["queue_cells_computed"] == 3
    monkeypatch.setenv("WARPSIM_BACKEND", "service")
    with pytest.raises(RuntimeError, match="no live daemon"):
        tapi.Session.from_env(device="cpu")
    monkeypatch.setenv("WARPSIM_BACKEND", "bogus")
    with pytest.raises(ValueError, match="expected inprocess"):
        tapi.Session.from_env(device="cpu")


def test_default_session_is_one_in_process_session():
    s = tapi.default_session()
    assert s is tapi.default_session()
    assert isinstance(s.backend, tapi.InProcessBackend)
    assert s.device == "cuda"


def test_figures_through_the_daemon(tmp_path, monkeypatch):
    """The port's figures take their session from ``Session.from_env``:
    with a daemon's URL set, Fig. 2's grid (90 cells at default sizes)
    is served by it, and a second pass simulates nothing."""
    monkeypatch.delenv("WARPSIM_BACKEND", raising=False)
    monkeypatch.delenv("WARPSIM_SERVICE_URLS", raising=False)
    svc = cpu_service(tmp_path / "d")
    want = tfigs.Figures(tapi.Session(device="cpu"),
                         results_dir=str(tmp_path / "a")).fig2_coalescing()
    with live(svc) as url:
        monkeypatch.setenv("WARPSIM_SERVICE_URL", url)
        rows = tfigs.Figures(tapi.Session.from_env(device="cpu"),
                             results_dir=str(tmp_path / "b")
                             ).fig2_coalescing()
        assert svc.counters["simulated"] == 90
        tfigs.Figures(tapi.Session.from_env(device="cpu"),
                      results_dir=str(tmp_path / "c")).fig2_coalescing()
        assert svc.counters["simulated"] == 90
    assert [(n, v) for n, _us, v in rows] == [(n, v) for n, _us, v in want]


# ------------------------------------------- kernel libraries, threads


def test_concurrent_first_build_makes_one_library(tmp_path, monkeypatch):
    """8 threads build the aggregation core at once into an empty build
    directory: no thread raises, all get one path, one library results and
    no temporary file is left."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    barrier = threading.Barrier(8)
    paths, errors = [], []

    def build():
        try:
            barrier.wait(30)
            paths.append(_native.build())
        except Exception as e:   # noqa: BLE001 — recorded and asserted
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(paths) == 8 and len(set(paths)) == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert [n for n in names if n.endswith(".so")] == [
        os.path.basename(paths[0])]
    assert not [n for n in names if n.endswith(".tmp")]
    assert names == sorted([os.path.basename(paths[0]),
                            os.path.basename(paths[0])[:-3] + ".log"])
    assert _nvcc.build_log(paths[0]) == ""


def test_concurrent_first_load_binds_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_LIB_PATH", None)
    builds = []
    orig = _native.build

    def counted():
        builds.append(1)
        return orig()

    monkeypatch.setattr(_native, "build", counted)
    barrier = threading.Barrier(8)
    libs = []

    def load():
        barrier.wait(30)
        libs.append(_native._lib())

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert len(builds) == 1
    assert _native.status()["library"] == _native.load()


@pytest.mark.parametrize("mod,kernel,route", [
    (_cuda, "ws_family_kernel", "shared"),
    (lm_lib, "gmm_kernel", "tensor_cores")], ids=["warpsim", "lm"])
def test_launch_counters_lose_no_increment(mod, kernel, route):
    """16 threads count launches at once with a short switch interval:
    no increment is lost."""
    mod.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                mod.count_launch(kernel, route)

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
        n, r = mod.launch_count(kernel), mod.route_count(kernel, route)
        mod.reset_launch_counts()
    assert not any(t.is_alive() for t in threads)
    assert n == r == 32000


# ------------------------------------------------ the facade grid file


def facade_grid_text() -> str:
    """The reference's records of the facade grid (its native engine,
    floats as ``float.hex()``), one record a line, with the study."""
    study = facade_parity.study()
    res = rapi.Session(backend=rapi.InProcessBackend(parallel=False)).run(
        rapi.Study.from_dict(dict(study.to_dict(), engine="native")))
    lines = ",\n".join(json.dumps(r, sort_keys=True)
                       for r in encode(res.records))
    return ('{"study": ' + json.dumps(study.to_dict()) + ',\n"records": [\n'
            + lines + "\n]}\n")


def write_facade_file() -> None:
    with open(FACADE_FILE, "w", encoding="utf-8") as fh:
        fh.write(facade_grid_text())


def test_facade_grid_file_is_current():
    with open(FACADE_FILE, encoding="utf-8") as fh:
        assert fh.read() == facade_grid_text()
    assert len(facade_parity.reference_records()) == 12


def test_facade_parity_backends_on_cpu(tmp_path):
    """The parity harness's three backends against a CPU daemon in this
    process: equal to each other and to the data file."""
    with live(cpu_service(tmp_path)) as url:
        out = facade_parity.run_backends(url, "cpu")
    assert set(out) == {"queue", "service", "inprocess"}


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_facade_grid_served_on_card(card, tmp_path):
    """A port daemon on the card serves the facade grid, one
    ``ws_family_kernel`` launch a simulated cell, equal to the file."""
    svc = tservice.SweepService(str(tmp_path), device=card)
    with live(svc) as url:
        assert tservice.SweepClient(url).healthz()["engine"] == "cuda"
        _cuda.reset_launch_counts()
        res = tapi.Session(device=card, backend=tapi.ServiceBackend(
            url)).run(facade_parity.study())
        torch.cuda.synchronize()
        assert _cuda.launch_count("ws_family_kernel") == 12
    assert encode(res.records) == facade_parity.reference_records()


@pytest.mark.gpu
def test_facade_parity_backends_on_card(card, tmp_path):
    with live(tservice.SweepService(str(tmp_path), device=card)) as url:
        out = facade_parity.run_backends(url, "cuda")
    assert out["queue"][0].stats["queue_cells_computed"] == 12


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-grid"]:
        write_facade_file()
        print(f"wrote {FACADE_FILE}")
    else:
        sys.exit("usage: python tests/test_torch_service.py --write-grid")
