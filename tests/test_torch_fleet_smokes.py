"""The port's fleet smokes (chaos, mesh, obs) against the reference's, on
the CPU.

Each scenario of ``repro_torch.benchmarks.{chaos,mesh,obs}_smoke`` runs
with ``device="cpu"`` (engine ``torch``, the family kernel's plain
version) beside the reference smoke's scenario of the same name on the
same study (``benchmarks/*_smoke.py``, native engine). The port's records
are held against the reference's in-process native records bit for bit
(floats by ``float.hex()``); its counters against every bound the
reference asserts, and against the reference's printed counts where those
are deterministic. The flaky-network scenario's daemon is a child process
(``--device cpu --engine torch``) whose fault plan arrives through
``service_smoke.child_env(extra=...)``. The CLIs run as child processes
beside the reference's: the same lines in the same order. Marked ``gpu``:
each smoke's ``main`` on the card.
"""

import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.core.warpsim import api as rapi
from repro_torch.benchmarks import chaos_smoke as tchaos
from repro_torch.benchmarks import mesh_smoke as tmesh
from repro_torch.benchmarks import obs_smoke as tobs
from repro_torch.benchmarks import service_smoke
from repro_torch.core.warpsim import api as tapi
from test_torch_service import encode, ref_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKES = ("chaos_smoke", "mesh_smoke", "obs_smoke")


def _reference_smoke(name: str):
    """The reference's ``benchmarks/<name>.py``, loaded from its file."""
    path = os.path.join(REPO, "benchmarks", name + ".py")
    spec = importlib.util.spec_from_file_location("reference_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


rchaos = _reference_smoke("chaos_smoke")
rmesh = _reference_smoke("mesh_smoke")
robs = _reference_smoke("obs_smoke")


def _study(**kw) -> tapi.Study:
    return service_smoke.small_study(**kw)


@pytest.fixture(scope="module")
def want():
    """The reference's in-process native records of the SMALL study."""
    return ref_records(_study(seeds=(0, 1)))


@pytest.fixture(scope="module")
def port_reference():
    """The port's in-process records of the SMALL study on the CPU: each
    port scenario's own reference, as the reference's smokes use their
    package in process."""
    return tapi.Session(device="cpu").run(_study(seeds=(0, 1)))


@pytest.fixture(scope="module")
def ref_reference():
    return rapi.Session().run(rchaos._study(seeds=(0, 1)))


def _printed(capsys, pattern):
    """The integers of `pattern`'s match in what was printed so far."""
    out = capsys.readouterr().out
    m = re.search(pattern, out)
    assert m, out
    return tuple(int(g) for g in m.groups())


def test_port_reference_equals_reference_records(port_reference, want):
    assert encode(port_reference.records) == want


# ------------------------------------------------------------ chaos


def test_chaos_daemon_kill(tmp_path, capsys, want, port_reference,
                           ref_reference):
    rchaos.scenario_daemon_kill(ref_reference, str(tmp_path / "ref"))
    ref_total, ref_cells = _printed(capsys,
                                    r"(\d+)/(\d+) single simulations")
    out = tchaos.scenario_daemon_kill(port_reference, str(tmp_path / "port"),
                                      device="cpu")
    assert encode(out["records"]) == want
    assert sum(out["simulated"]) == out["cells"] == ref_total == ref_cells
    assert out["retries"] >= 2 and out["failovers"] >= 1
    assert out["launches"] == 0


def test_chaos_flaky_network_child_daemon(tmp_path, capsys, want,
                                          port_reference, ref_reference):
    """The port's daemon is a child process on the CPU (engine torch); its
    fault plan arrives through its environment: two faults injected."""
    rchaos.scenario_flaky_network(ref_reference, str(tmp_path / "ref"))
    ref_sim, ref_cells = _printed(capsys, r"(\d+)/(\d+) single simulations")
    out = tchaos.scenario_flaky_network(port_reference,
                                        str(tmp_path / "port"), device="cpu")
    assert encode(out["records"]) == want
    assert out["retries"] == 2
    assert out["simulated"] == out["cells"] == ref_sim == ref_cells
    assert out["faults_injected"] == 2
    assert out["launches"] == 0


def test_chaos_worker_corruption_and_drain(tmp_path, capsys):
    study = _study(benches=("BFS",))
    rchaos.scenario_worker_corruption_and_drain(str(tmp_path / "ref"))
    ref_adopted, ref_cells = _printed(capsys,
                                      r"(\d+)/(\d+) single adoptions")
    out = tchaos.scenario_worker_corruption_and_drain(
        str(tmp_path / "port"), device="cpu")
    assert encode(out["records"]) == ref_records(study)
    assert out["worker_cells"] == out["adopted"] == out["cells"] \
        == ref_adopted == ref_cells == len(study.cells())
    assert out["jobs_persisted"] == 1


def test_child_env_takes_registered_variables_only():
    env = service_smoke.child_env("http://x", extra={
        "WARPSIM_FAULTS": tchaos.FLAKY_FAULTS})
    assert env["WARPSIM_FAULTS"] == tchaos.FLAKY_FAULTS
    assert env["WARPSIM_SERVICE_URL"] == "http://x"
    with pytest.raises(ValueError, match="WARPSIM_NO_SUCH"):
        service_smoke.child_env(extra={"WARPSIM_NO_SUCH": "1"})


# ------------------------------------------------------------- mesh


def test_mesh_cold_then_warm(tmp_path, capsys, want, port_reference,
                             ref_reference):
    rmesh.scenario_cold_then_warm(ref_reference, str(tmp_path / "ref"))
    (ref_cells,) = _printed(capsys, r"(\d+) cells simulated once")
    out = tmesh.scenario_cold_then_warm(port_reference,
                                        str(tmp_path / "port"), device="cpu")
    assert encode(out["records"]) == want
    assert sum(out["simulated"]) == out["cells"] == ref_cells
    assert out["warm_stats"]["simulated"] == 0
    assert out["cold_launches"] == out["warm_launches"] == 0
    # Every simulated cell was pushed to its replica successor(s).
    assert sum(m["replicas_adopted"] for m in out["mesh"]) \
        >= out["cells"] * (tmesh.REPLICATION - 1)


def test_mesh_owner_killed_mid_study(tmp_path, want, port_reference,
                                     ref_reference):
    rmesh.scenario_owner_killed_mid_study(ref_reference,
                                          str(tmp_path / "ref"))
    out = tmesh.scenario_owner_killed_mid_study(
        port_reference, str(tmp_path / "port"), device="cpu")
    assert encode(out["records"]) == want
    assert 0 <= out["duplicates"] <= tmesh.REPLICATION == rmesh.REPLICATION
    assert sum(out["simulated"]) == out["cells"] + out["duplicates"]
    assert out["simulated"][out["victim"]] >= 3
    assert out["failovers"] >= 1
    assert out["launches"] == 0


def test_mesh_queue_job_adoption(tmp_path, want, port_reference,
                                 ref_reference):
    rmesh.scenario_queue_job_adoption(ref_reference, str(tmp_path / "ref"))
    out = tmesh.scenario_queue_job_adoption(
        port_reference, str(tmp_path / "port"), device="cpu")
    assert encode(out["records"]) == want
    assert out["adoptions"] == 1
    assert out["worker_cells"] == out["cells"]
    assert out["launches"] == 0


# -------------------------------------------------------------- obs


def test_obs_metrics(tmp_path, capsys, want, port_reference, ref_reference):
    study = _study(seeds=(0, 1))
    with robs.mesh_duo(str(tmp_path / "ref")) as (svcs, urls):
        robs.check_metrics(ref_reference, svcs, urls, rchaos._study(
            seeds=(0, 1)))
    (ref_total,) = _printed(capsys, r"(\d+) cells simulated once")
    with tobs.mesh_duo(str(tmp_path / "port"), "cpu") as (svcs, urls):
        out = tobs.check_metrics(port_reference, svcs, urls, study, "cpu")
    assert encode(out["records"]) == want
    assert sum(out["simulated"]) == out["cells"] == ref_total
    assert out["cold_launches"] == out["warm_launches"] == 0


def test_obs_study_and_queue_traces(tmp_path, want, port_reference,
                                    ref_reference):
    """One rooted trace each, with the reference's required span names
    (checked inside the scenarios, which raise otherwise); the queue
    study's records against the reference's on seeds 2-3."""
    rstudy = rchaos._study(seeds=(2, 3))
    with robs.mesh_duo(str(tmp_path / "ref")) as (svcs, urls):
        robs.check_study_trace(ref_reference, svcs, urls,
                               rchaos._study(seeds=(0, 1)))
        robs.check_queue_trace(svcs, urls, rstudy)
    queue_study = _study(seeds=(2, 3))
    with tobs.mesh_duo(str(tmp_path / "port"), "cpu") as (svcs, urls):
        trace = tobs.check_study_trace(port_reference, svcs, urls,
                                       _study(seeds=(0, 1)), "cpu")
        queue = tobs.check_queue_trace(svcs, urls, queue_study, "cpu")
    assert encode(trace["records"]) == want
    assert trace["spans"] > 0 and len(trace["per_daemon"]) == 2
    assert encode(queue["records"]) == ref_records(queue_study)
    assert queue["worker_cells"] > 0 and queue["chunks"] > 0


# -------------------------------------------------------------- CLIs


def _labels(text: str) -> list:
    """Each printed line's first two words: the line's label."""
    return [" ".join(line.split()[:2]) for line in text.splitlines()
            if line.strip()]


@pytest.mark.parametrize("name", SMOKES)
def test_cli_prints_the_reference_lines(name):
    """``--device cpu`` exits 0 with the reference smoke's lines in the
    reference's order; without a card and without ``--device cpu`` the
    smoke exits non-zero, naming the missing device."""
    env = service_smoke.child_env()
    runs = {"port": [sys.executable, "-m", f"repro_torch.benchmarks.{name}",
                     "--device", "cpu"],
            "ref": [sys.executable, "-m", f"benchmarks.{name}"]}
    if not torch.cuda.is_available():
        runs["no_card"] = [sys.executable, "-m",
                           f"repro_torch.benchmarks.{name}"]
    procs = {k: subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, argv in runs.items()}
    done = {k: p.communicate(timeout=240) + (p.returncode,)
            for k, p in procs.items()}
    port_out, port_err, port_rc = done["port"]
    ref_out, _ref_err, ref_rc = done["ref"]
    assert port_rc == 0 and ref_rc == 0, port_err
    assert _labels(port_out) == _labels(ref_out)
    if "no_card" in done:
        _out, err, rc = done["no_card"]
        assert rc != 0 and "no CUDA device" in err, err


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("module", [tchaos, tmesh, tobs],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_smoke_main_on_card(card, module):
    """Each smoke on the card: every check, the launch contract included
    (one ``ws_family_kernel`` launch a simulated cell, none warm)."""
    module.main(["--device", card])
