"""The port's fleet layers against the reference's, on the CPU: the
environment registry, mesh rankings, fault plans, the resilient client,
typed HTTP failures, drain, and the state the two packages' daemons share
on disk (queue-job snapshots adopted both ways) or over the wire (a mesh
that mixes both packages' daemons).

Port daemons run with ``device="cpu"``, ``engine="torch"`` at 128
threads a cell; records are held against the reference's in-process
records bit for bit.
"""

import dataclasses
import hashlib
import os
import socket

import pytest

from repro.core.warpsim import envcfg as renvcfg
from repro.core.warpsim import faults as rfaults
from repro.core.warpsim import mesh as rmesh
from repro.core.warpsim import service as rservice
from repro.core.warpsim import work_queue as rwq
from repro_torch.core.warpsim import api as tapi
from repro_torch.core.warpsim import envcfg as tenvcfg
from repro_torch.core.warpsim import faults as tfaults
from repro_torch.core.warpsim import mesh as tmesh
from repro_torch.core.warpsim import service as tservice
from repro_torch.core.warpsim import work_queue as twq
from test_torch_service import (
    cpu_service, encode, live, ref_records, ref_study, small_study,
)

# (service module, faults module) of the port, then of the reference.
PAIRS = [(tservice, tfaults), (rservice, rfaults)]


def _noop_sleep(_seconds):
    pass


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _dead_url():
    """A URL that refuses connections right now."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


class ScriptedTransport:
    """Fake ``_http_json``: per-base-URL scripted responses/exceptions,
    consumed in order (the last repeats); records (url, op header)."""

    def __init__(self, script, flt):
        self.script = {u.rstrip("/"): list(seq) for u, seq in script.items()}
        self.flt = flt          # the faults module whose errors to raise
        self.calls = []

    def __call__(self, url, body=None, timeout=60.0, headers=None):
        self.calls.append((url, (headers or {}).get("X-Warpsim-Op")))
        for known, seq in self.script.items():
            if url.startswith(known):
                behavior = seq.pop(0) if len(seq) > 1 else seq[0]
                if behavior == "down":
                    raise self.flt.ServiceUnavailable(
                        f"refused (scripted) {url}", url=known, path="/x")
                if behavior == "404":
                    raise self.flt.ServiceError(
                        "HTTP 404", url=known, path="/x", code=404)
                return behavior
        raise self.flt.ServiceUnavailable(f"unscripted url {url}", url=url,
                                          path="/")


# ------------------------------------------------------------ envcfg


def test_envcfg_is_a_subset_of_the_reference_with_equal_defaults():
    assert set(tenvcfg.REGISTRY) < set(renvcfg.REGISTRY)
    for name, var in tenvcfg.REGISTRY.items():
        assert dataclasses.astuple(var) == dataclasses.astuple(
            renvcfg.REGISTRY[name]), name
    assert not {"WARPSIM_NATIVE", "WARPSIM_NATIVE_DIR",
                "WARPSIM_PALLAS"} & set(tenvcfg.REGISTRY)
    assert set(tenvcfg.REGISTRY) == {
        "WARPSIM_BACKEND", "WARPSIM_SERVICE_URL", "WARPSIM_SERVICE_URLS",
        "WARPSIM_PEERS", "WARPSIM_SELF_URL", "WARPSIM_REPLICATION",
        "WARPSIM_FAULTS", "WARPSIM_OBS", "WARPSIM_OBS_RING",
        "WARPSIM_OBS_SAMPLE"}
    assert tenvcfg.DISABLED_VALUES == renvcfg.DISABLED_VALUES


def test_envcfg_accessors(monkeypatch):
    monkeypatch.delenv("WARPSIM_OBS", raising=False)
    assert tenvcfg.enabled("WARPSIM_OBS")
    monkeypatch.setenv("WARPSIM_OBS", "off")
    assert not tenvcfg.enabled("WARPSIM_OBS")
    monkeypatch.setenv("WARPSIM_REPLICATION", "3")
    assert tenvcfg.get_int("WARPSIM_REPLICATION") == 3
    for name in ("WARPSIM_PALLAS", "PATH"):
        with pytest.raises(KeyError):
            tenvcfg.get(name)


# -------------------------------------------------------------- mesh


MEMBER_SETS = [
    ["http://a:1", "http://b:2", "http://c:3"],
    ["http://10.0.0.1:8321", "http://10.0.0.2:8321"],
    [f"http://h{i}:83{i:02d}" for i in range(7)],
]


@pytest.mark.parametrize("members", MEMBER_SETS,
                         ids=["three", "two", "seven"])
@pytest.mark.parametrize("replication", [1, 2, 3])
def test_mesh_rankings_equal_reference(members, replication):
    keys = [hashlib.sha256(str(i).encode()).hexdigest() for i in range(200)]
    for me in (members[0], members[-1]):
        ours = tmesh.MeshConfig.build(me, members, replication=replication)
        theirs = rmesh.MeshConfig.build(me, members,
                                        replication=replication)
        assert ours.members == theirs.members
        for key in keys:
            assert ours.ranking(key) == theirs.ranking(key)
            assert ours.owner(key) == theirs.owner(key)
            assert ours.targets(key) == theirs.targets(key)
            assert ours.fetch_order(key) == theirs.fetch_order(key)
            assert ours.replica_targets(key) == theirs.replica_targets(key)
            assert ours.job_targets("job-" + key[:8]) == \
                theirs.job_targets("job-" + key[:8])


def test_mesh_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("WARPSIM_PEERS", "http://b:2/, http://c:3,http://a:1")
    monkeypatch.setenv("WARPSIM_SELF_URL", "http://a:1")
    monkeypatch.setenv("WARPSIM_REPLICATION", "3")
    assert tmesh.MeshConfig.from_env().describe() == \
        rmesh.MeshConfig.from_env().describe()
    monkeypatch.delenv("WARPSIM_SELF_URL")
    with pytest.raises(ValueError):
        tmesh.MeshConfig.from_env()


# ------------------------------------------------------------ faults


SPECS = [
    "server/study:error=503,times=2;service.cell:kill,after=5",
    "seed=7;worker.*:drop,p=0.5,times=inf;client.request:delay=0.2",
    "server/*:corrupt,after=1,times=3;response/cell:drop;peer.*:drop,p=0.3",
]
POINTS = ["server/study", "server/cell", "response/cell", "service.cell",
          "worker.lease", "worker.renew", "worker.complete",
          "client.request", "peer.forward", "peer.replicate"]


@pytest.mark.parametrize("spec", SPECS, ids=["kill", "seeded", "globs"])
def test_fault_plan_fires_like_reference(spec):
    """The same plan string, checked at the same points with the same
    markers, fires the same faults in both packages."""
    ours = tfaults.FaultPlan.from_spec(spec)
    theirs = rfaults.FaultPlan.from_spec(spec)
    assert [dataclasses.asdict(r) for r in ours.rules] == \
        [dataclasses.asdict(r) for r in theirs.rules]
    decisions = [[], []]
    for i, plan in enumerate((ours, theirs)):
        for step in range(300):
            point = POINTS[step % len(POINTS)]
            marker = None if step % 4 == 0 else f"op{step % 37}"
            fault = plan.check(point, marker)
            decisions[i].append(None if fault is None
                                else dataclasses.astuple(fault))
    assert decisions[0] == decisions[1]
    assert any(decisions[0])
    assert ours.stats() == theirs.stats()


def test_fault_points_and_grammar_equal_reference(monkeypatch):
    assert tfaults.KNOWN_POINTS == rfaults.KNOWN_POINTS
    assert tfaults.ACTIONS == rfaults.ACTIONS
    assert tfaults.fault_point("server/study") == "server/study"
    with pytest.raises(ValueError, match="KNOWN_POINTS"):
        tfaults.fault_point("peer.gossip")  # warpsim-lint: disable=fault-registry
    for bad in ("nocolon", "x:explode", "x:drop=3", "x:drop,bogus=1"):
        with pytest.raises(ValueError):
            tfaults.FaultPlan.from_spec(bad)
    monkeypatch.setenv("WARPSIM_FAULTS", "server/study:error=500;seed=3")
    plan = tfaults.FaultPlan.from_env()
    assert plan.seed == 3 and plan.rules[0].code == 500


# -------------------------------------------------- the resilient client


def _scenario_failover(svc, flt):
    a, b = "http://a:1", "http://b:2"
    t = ScriptedTransport({a: ["down"], b: [{"pong": 1}]}, flt)
    client = svc.ResilientClient([a, b], sleep=_noop_sleep, transport=t)
    out = [client._get("/ping"), client._get("/again"), client.last_url]
    return out, client.client_stats(), [u for u, _ in t.calls]


def _scenario_breaker(svc, flt):
    a = "http://a:1"
    clock = FakeClock()
    t = ScriptedTransport({a: ["down", "down", {"ok": True}, {"pong": 1}]}, flt)
    client = svc.ResilientClient([a], max_retries=1, breaker_threshold=2,
                                 breaker_cooldown=5.0, sleep=_noop_sleep,
                                 clock=clock, transport=t)
    out = []
    for t_now in (0.0, 1.0, 6.0):
        clock.t = t_now
        try:
            out.append(client._get("/ping"))
        except flt.ServiceUnavailable as e:
            out.append(("unavailable", e.attempts, e.path))
        out.append(client.endpoints[0].state)
    return out, client.client_stats(), [u for u, _ in t.calls]


def _scenario_non_transient(svc, flt):
    a, b = "http://a:1", "http://b:2"
    t = ScriptedTransport({a: ["404"], b: [{"never": 1}]}, flt)
    client = svc.ResilientClient([a, b], sleep=_noop_sleep, transport=t)
    with pytest.raises(flt.ServiceError) as ei:
        client._get("/x")
    assert not isinstance(ei.value, flt.ServiceUnavailable)
    return ([ei.value.code, ei.value.attempts], client.client_stats(),
            [u for u, _ in t.calls])


def _scenario_client_fault(svc, flt):
    a = "http://a:1"
    t = ScriptedTransport({a: [{"pong": 1}]}, flt)
    plan = flt.FaultPlan.from_spec("client.request:drop,times=1")
    client = svc.ResilientClient([a], sleep=_noop_sleep, transport=t,
                                 fault_plan=plan)
    return [client._get("/ping")], client.client_stats(), \
        [u for u, _ in t.calls]


def _scenario_exhausted(svc, flt):
    a, b = "http://a:1", "http://b:2"
    t = ScriptedTransport({a: ["down"], b: ["down"]}, flt)
    client = svc.ResilientClient([a, b], max_retries=3, breaker_threshold=99,
                                 sleep=_noop_sleep, transport=t)
    with pytest.raises(flt.ServiceUnavailable) as ei:
        client._get("/stats")
    assert isinstance(ei.value.__cause__, flt.ServiceUnavailable)
    return [ei.value.attempts, ei.value.path], client.client_stats(), \
        [u for u, _ in t.calls]


@pytest.mark.parametrize("scenario", [
    _scenario_failover, _scenario_breaker, _scenario_non_transient,
    _scenario_client_fault, _scenario_exhausted],
    ids=["failover", "breaker", "non_transient", "client_fault",
         "exhausted"])
def test_resilient_client_behaves_like_reference(scenario):
    """Retries, failover, the breaker and injected client faults: the
    port's client makes the same calls, results and counters as the
    reference's on the same script."""
    ours, theirs = (scenario(*pair) for pair in PAIRS)
    assert ours == theirs


def test_resilient_client_retry_stats():
    out, stats, calls = _scenario_failover(tservice, tfaults)
    assert out == [{"pong": 1}, {"pong": 1}, "http://b:2"]
    assert stats["retries"] == 1 and stats["failovers"] == 1
    out, stats, calls = _scenario_breaker(tservice, tfaults)
    assert out[1] == "open" and out[-1] == "closed"
    assert stats["breaker_opens"] == 1 and stats["probes"] == 1
    assert calls[-2] == "http://a:1/healthz"


# ------------------------------------------------- typed HTTP failures


def test_http_json_failures_are_typed(tmp_path):
    url = _dead_url()
    with pytest.raises(tfaults.ServiceUnavailable) as ei:
        twq._http_json(url + "/healthz", timeout=5)
    assert (ei.value.url, ei.value.path, ei.value.code) == (url, "/healthz",
                                                            None)
    plan = tfaults.FaultPlan.from_spec("server/stats:drop")
    with live(cpu_service(tmp_path, fault_plan=plan)) as live_url:
        with pytest.raises(tfaults.ServiceError) as ei:
            twq._http_json(live_url + "/nope")
        assert ei.value.code == 404 and not ei.value.is_transient
        assert "unknown path" in str(ei.value)
        with pytest.raises(tfaults.ServiceError) as ei:
            twq._http_json(live_url + "/cell?bench=BFS&machine=ws7x")
        assert ei.value.code == 400
        with pytest.raises(tfaults.ServiceUnavailable):
            twq._http_json(live_url + "/stats")     # dropped connection
        assert twq._http_json(live_url + "/stats")["counters"][
            "faults_injected"] == 1


def test_session_raises_typed_error_for_a_dead_daemon():
    url = _dead_url()
    session = tapi.Session(device="cpu", backend=tapi.ServiceBackend(
        url=url, timeout=2.0))
    with pytest.raises(tapi.ServiceUnavailable) as ei:
        session.run(small_study(seeds=(0,), benches=("BFS",)))
    assert ei.value.url == url and ei.value.path == "/study"
    assert tapi.ServiceError is tfaults.ServiceError


# --------------------------------------------- daemon-side fault points


def test_server_error_fault_fires_once_per_operation(tmp_path):
    plan = tfaults.FaultPlan.from_spec("server/study:error=503,times=1")
    svc = cpu_service(tmp_path, fault_plan=plan)
    study = small_study(seeds=(0,))
    with live(svc) as url:
        with pytest.raises(tfaults.ServiceError) as ei:
            tservice.SweepClient(url).study(study)
        assert ei.value.code == 503
        client = tservice.ResilientClient([url], sleep=_noop_sleep)
        res = tapi.Session(device="cpu",
                           backend=tapi.ServiceBackend(client=client)
                           ).run(study)
    assert svc.counters["faults_injected"] == 1
    assert encode(res.records) == ref_records(study)


def test_worker_survives_corrupt_complete(tmp_path):
    study = small_study(seeds=(0,), benches=("DYN",))
    svc = cpu_service(tmp_path, persist_traces=False)
    plan = tfaults.FaultPlan.from_spec("worker.complete:corrupt,times=1")
    with live(svc) as url:
        job = tservice.SweepClient(url).enqueue(study.to_spec(),
                                                chunk_size=3)
        n = twq.run_worker(url, job["job"], device="cpu", poll_seconds=0.01,
                           sleep=_noop_sleep, fault_plan=plan)
        status = tservice.SweepClient(url).queue_status(job["job"])
    assert n == 3 and status["completed"] == 1
    assert svc.counters["errors"] == 1              # the corrupt POST
    assert svc.counters["queue_cells_adopted"] == 3
    assert plan.stats()["fired"] == {"worker.complete": 1}


def test_drain_refuses_new_work_and_persists_queue(tmp_path):
    svc = cpu_service(tmp_path, persist_traces=False)
    with live(svc) as url:
        client = tservice.SweepClient(url)
        job = client.enqueue(small_study(seeds=(0,)).to_spec(), chunk_size=4)
        got = client.drain(wait_seconds=1.0)
        assert got["draining"] and got["jobs_persisted"] == 1
        assert client.healthz()["draining"]
        with pytest.raises(tfaults.ServiceError) as ei:
            client.study(small_study(seeds=(0,)))
        assert ei.value.code == 503
        lease = twq._http_json(url + f"/queue/lease?job={job['job']}")
        assert lease["chunk"] is None and lease["draining"]
    assert os.path.exists(os.path.join(str(tmp_path), "queue",
                                       job["job"] + ".json"))


# ------------------------------------------ shared state between packages


def test_reference_job_snapshot_adopted_by_port_daemon(tmp_path):
    """A reference daemon enqueues a job and is gone; a port daemon on the
    same cache root adopts ``queue/<job>.json`` and a port worker drains
    it, with the reference's records."""
    study = small_study(seeds=(4,))
    ref = rservice.SweepService(str(tmp_path), persist_traces=False)
    job = ref.enqueue(study.to_spec(), chunk_size=2)
    lease = ref.queue_lease(job["job"], "w-gone")   # leased, never done
    del ref
    svc = cpu_service(tmp_path, persist_traces=False)
    assert svc.queue_status(job["job"])["leased"] == 1
    with live(svc) as url:
        n = twq.run_worker(url, job["job"], device="cpu", poll_seconds=0.01,
                           max_chunks=2)
        assert n == 4
        svc.queue_complete(job["job"], lease["chunk"], "w-gone", [])
        n += twq.run_worker(url, job["job"], device="cpu", poll_seconds=0.01)
        res = tapi.Session(device="cpu",
                           backend=tapi.ServiceBackend(url)).run(study)
    status = svc.queue_status(job["job"])
    assert status["completed"] == 3
    # The gone worker's chunk was completed with no results: its 2 cells
    # are simulated by the daemon for the study.
    assert n == 4 and res.stats["simulated"] == 2
    assert encode(res.records) == ref_records(study)


def test_port_job_snapshot_adopted_by_reference_daemon(tmp_path):
    study = small_study(seeds=(5,))
    svc = cpu_service(tmp_path, persist_traces=False)
    job = svc.enqueue(study.to_spec(), chunk_size=3)
    del svc
    ref = rservice.SweepService(str(tmp_path), persist_traces=False)
    assert ref.queue_status(job["job"])["pending"] == 2
    with live(ref) as url:
        assert rwq.run_worker(url, job["job"], poll_seconds=0.01) == 6
        res = tapi.Session(device="cpu",
                           backend=tapi.ServiceBackend(url)).run(study)
    assert res.stats["simulated"] == 0
    assert encode(res.records) == ref_records(study)
    # ... and back: the drained snapshot reloads in the port.
    again = cpu_service(tmp_path, persist_traces=False)
    assert again.queue_status(job["job"])["completed"] == 2


def test_mixed_mesh_reads_through_and_replicates(tmp_path):
    """A port daemon and a reference daemon over disjoint roots, federated:
    a study through the port daemon forwards the cells the reference
    daemon owns, and records equal the reference's."""
    port_svc = cpu_service(tmp_path / "p", persist_traces=False,
                           mesh=False)
    ref_svc = rservice.SweepService(str(tmp_path / "r"),
                                    persist_traces=False, mesh=False)
    study = small_study(seeds=(6,))
    with live(port_svc) as purl, live(ref_svc) as rurl:
        port_svc.configure_mesh(tmesh.MeshConfig.build(purl, [rurl]))
        ref_svc.configure_mesh(rmesh.MeshConfig.build(rurl, [purl]))
        res = tapi.Session(device="cpu",
                           backend=tapi.ServiceBackend(purl)).run(study)
        again = rservice.SweepClient(rurl).study(ref_study(study))
    owners = [tmesh.rendezvous_ranking(
        tservice.cell_key(b, cfg, n, s), [purl, rurl])[0]
        for _m, cfg, b, n, s in study.cells()]
    n_ref = owners.count(rurl)
    assert 0 < n_ref < 6
    assert port_svc.counters["peer_hits"] == n_ref
    assert port_svc.counters["simulated"] == 6 - n_ref
    assert port_svc.counters["replicas_sent"] == 6 - n_ref
    assert ref_svc.counters["replicas_adopted"] == 6 - n_ref
    assert again.stats["simulated"] == 0
    assert encode(res.records) == encode(again.records) == \
        ref_records(study)
