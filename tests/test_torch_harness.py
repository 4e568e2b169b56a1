"""The port's benchmark harness held against the reference's.

* ``moe_dispatch_bench``: the port's tokens and routers (drawn from
  ``torch.Generator`` seeds) go through the reference's router as numpy
  arrays: the skewed router within rtol 1e-6 (its log bias, an ulp
  apart), the top-k choices, slot efficiencies and drop rates exactly
  (integer counts); each strategy's output on the CPU against the dense
  oracle (LW+'s with its dropped assignments left out) within K4's
  float32 tolerance (rtol 2e-5, atol 1.6e-4).
* ``sweep_bench --quick`` on the CPU: the counter rows equal the
  reference's ``run_sweep_with_stats`` counters of the same grid, cold
  and warm; the warm run simulates and launches nothing.
* ``run``: ``--only moe,roofline --device cpu`` prints the CSV header and
  the rows and exits 0; when a bench raises, the others still print and
  the exit code is 1.

The ``gpu`` tests run ``chip_smoke.py``'s harness phase (a)-(e) on a
card (``benchmarks.harness_smoke``).
"""

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import harness_smoke
from repro_torch.benchmarks import moe_dispatch_bench as tbench
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import sweep_bench as tsweep_bench
from repro_torch.models import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_bench(name: str):
    """The reference's ``benchmarks/<name>.py``, loaded from its file."""
    path = os.path.join(REPO, "benchmarks", name + ".py")
    spec = importlib.util.spec_from_file_location("reference_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


try:
    import jax.numpy as jnp

    rbench = _reference_bench("moe_dispatch_bench")
    rsweep_bench = _reference_bench("sweep_bench")
    from repro.core.warpsim import machines as rmachines
    from repro.core.warpsim import sweep as rsweep
    from repro.models import moe as rmoe
except ImportError:     # a machine with a card and no jax
    jnp = None


def _need_reference():
    if jnp is None:
        pytest.skip("needs jax, the reference package's framework")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


# ------------------------------------------------------- moe dispatch bench


@pytest.fixture(scope="module")
def moe_cases():
    cfg = tbench._cfg()
    x, routers = tbench.inputs(cfg)
    return cfg, x, routers, {label: tbench.case(p, x, cfg, "cpu", reps=0)
                             for label, p in routers.items()}


@pytest.mark.parametrize("label,skew", tbench.ROUTERS)
def test_moe_bench_routing_equals_reference(moe_cases, label, skew):
    _need_reference()
    cfg, x, routers, cases = moe_cases
    rcfg = rbench._cfg(1.25)
    base = {k: jnp.asarray(v.numpy())
            for k, v in routers["balanced"].items()}
    ref_params = rbench._skewed_router(base, skew, None)
    np.testing.assert_allclose(routers[label]["router"].numpy(),
                               np.asarray(ref_params["router"]), rtol=1e-6)
    _, idx, _ = rmoe.router_probs(
        {k: jnp.asarray(v.numpy()) for k, v in routers[label].items()},
        jnp.asarray(x.numpy()), rcfg)
    idx = np.asarray(idx)
    got = cases[label]
    assert np.array_equal(got["idx"].numpy(), idx)
    t = x.shape[0]
    assert got["slot_eff"] == {
        "lw_plus": rbench.lw_slot_efficiency(rcfg, idx, t),
        "sw_plus": rbench.sw_slot_efficiency(rcfg, idx)}
    counts = np.bincount(idx.reshape(-1), minlength=rcfg.moe_experts_eff)
    cap = rmoe.capacity(rcfg, t)
    assert got["drop_rate"] == float(np.maximum(counts - cap, 0).sum()
                                     / idx.size)


@pytest.mark.parametrize("label", [r for r, _ in tbench.ROUTERS])
@pytest.mark.parametrize("strategy", list(tbench.STRATEGIES))
def test_moe_bench_outputs_match_dense_oracle(moe_cases, label, strategy):
    cfg, x, routers, cases = moe_cases
    got = cases[label]
    kept = (tbench.lw_kept(cfg, got["idx"], x.shape[0])
            if strategy == "lw_plus" else None)
    with torch.no_grad():
        want, _ = tmoe.dispatch_dense_oracle(routers[label], x, cfg, kept)
    np.testing.assert_allclose(got["y"][strategy].numpy(), want.numpy(),
                               rtol=harness_smoke.K4_TOL[0],
                               atol=harness_smoke.K4_TOL[1])


def test_moe_bench_skew_drops_tokens(moe_cases):
    """The balanced router fits LW+'s capacity; the Zipf router overflows
    it, and SW+ then wastes fewer slots than LW+ (the paper's trade)."""
    _, _, _, cases = moe_cases
    assert cases["balanced"]["drop_rate"] == 0.0
    skewed = cases["skewed"]
    assert skewed["drop_rate"] > 0.3
    assert skewed["slot_eff"]["sw_plus"] > skewed["slot_eff"]["lw_plus"]


# -------------------------------------------------------------- sweep bench


def _reference_counters() -> dict:
    spec = rsweep.SweepSpec(machines=rmachines.paper_suite(),
                            benches=rsweep_bench.QUICK_BENCHES,
                            n_threads=rsweep_bench.QUICK_N_THREADS)
    root = tempfile.mkdtemp(prefix="ref-sweep-bench-")
    try:
        rsweep.EXPANSION_CACHE.clear()
        rsweep.TRACE_CACHE.clear()
        _, cold = rsweep.run_sweep_with_stats(spec,
                                              cache=rsweep.ResultCache(root))
        _, warm = rsweep.run_sweep_with_stats(spec,
                                              cache=rsweep.ResultCache(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    names = ("cells", "cache_misses", "trace_families", "traces_shared",
             "expansion_groups", "expansions_saved")
    out = {f"sweep/cold_{k}": float(cold[k]) for k in names}
    out.update({f"sweep/warm_{k}": float(warm[k])
                for k in ("cache_hits", "cache_misses")})
    return out


def test_sweep_bench_quick_counters_equal_reference():
    _need_reference()
    assert tsweep_bench.QUICK_BENCHES == rsweep_bench.QUICK_BENCHES
    assert tsweep_bench.QUICK_N_THREADS == rsweep_bench.QUICK_N_THREADS
    rows = {name: (us, d) for name, us, d in
            tsweep_bench.run(quick=True, device="cpu")}
    for name, want in _reference_counters().items():
        assert rows[name] == (0.0, want), name
    assert rows["sweep/cold_family_launches"][1] == len(
        tsweep_bench.QUICK_BENCHES)
    assert rows["sweep/warm_family_launches"][1] == 0.0
    assert rows["sweep/warm_cache_misses"][1] == 0.0
    for name in ("sweep/trace_build", "sweep/cold", "sweep/warm"):
        assert rows[name][0] > 0
    # The reference's convention: a timing row's derived value is its
    # speedup over serial_event.
    assert rows["sweep/cold"][1] == pytest.approx(
        rows["sweep/serial_event"][0] / rows["sweep/cold"][0], rel=1e-9)


# ------------------------------------------------------------------- run.py


def test_run_prints_csv_and_exits_0():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
         "moe,roofline", "--device", "cpu"], env=_env(),
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = harness_smoke.csv_rows(proc.stdout)
    names = [n for n, _, _ in rows]
    assert names[:6] == [f"moe/{label}/{name}" for label, _ in tbench.ROUTERS
                         for name in ("lw_plus/slot_eff", "sw_plus/slot_eff",
                                      "lw_plus/drop_rate")]
    assert all(n.startswith("roofline/") for n in names[6:]) and names[6:]


def test_run_reports_every_failure_and_exits_1(monkeypatch, capsys):
    def broken(device="cuda"):
        raise RuntimeError("bench broke")

    monkeypatch.setattr(tbench, "run", broken)
    assert trun.main(["--only", "moe,roofline", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "bench broke" in err and "Traceback" in err
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert any(ln.startswith("roofline/") for ln in out.splitlines())


# ------------------------------------------------------------------ the card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.fixture
def work():
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    path = tempfile.mkdtemp(dir=build)
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.mark.gpu
def test_moe_bench_on_card(card):
    out = harness_smoke.moe_check(card)
    assert len(out["rows"]) == 6


@pytest.mark.gpu
def test_sweep_bench_on_card(card):
    rows = {n: d for n, _, d in harness_smoke.sweep_check(card)}
    assert rows["sweep/cold_family_launches"] == len(
        tsweep_bench.QUICK_BENCHES)
    assert rows["sweep/warm_family_launches"] == 0.0


@pytest.mark.gpu
def test_dryrun_and_run_on_card(card, work):
    for name, argv in (("dryrun", harness_smoke.DRYRUN),
                       ("run", harness_smoke.RUN)):
        result = harness_smoke.finish(harness_smoke.start(name, argv, work))
        harness_smoke.check_finished(name, result)
    rows = harness_smoke.csv_rows(result["stdout"])
    assert any(n.startswith("roofline/tinyllama-1.1b/train_4k")
               for n, _, _ in rows)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["quickstart", "serve_batched",
                                  "train_resume", "warpsize_study"])
def test_example_on_card(card, work, name):
    argv = harness_smoke.example_commands(work)[name]
    harness_smoke.check_finished(name, harness_smoke.finish(
        harness_smoke.start(name, argv, work)))
