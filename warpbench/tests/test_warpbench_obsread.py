"""K2's time a step by placement, read from the program's own
registry."""

import json
import os
import subprocess
import sys

import pytest

from warpbench import obsread, run, spec
from warpbench.tests import tiny

K2_READERS = ("k2.global_ns_per_step", "k2.shared_ns_per_step")


def test_k2_readers_divide_the_programs_seconds_by_its_steps(monkeypatch):
    from repro_torch.core.warpsim import _cuda, obs
    ob = obs.Observability()
    monkeypatch.setattr(obs, "default", lambda: ob)
    assert [spec.reader(m)(None) for m in K2_READERS] == [None, None]
    secs, steps = _cuda.k2_metrics(ob)
    for placement, s, n in (("global", 0.003, 2000), ("global", 0.001, 500),
                            ("shared", 0.002, 4000)):
        secs.labels(placement=placement).observe(s)
        steps.labels(placement=placement).inc(n)
    assert spec.reader("k2.global_ns_per_step")(None) == pytest.approx(
        1e9 * 0.004 / 2500)
    assert spec.reader("k2.shared_ns_per_step")(None) == pytest.approx(
        1e9 * 0.002 / 4000)
    assert obsread.series(ob.registry.snapshot(), "warpsim_k2_seconds",
                          "placement") == {
        "global": (pytest.approx(0.004), 2), "shared": (0.002, 1)}


def test_k2_readers_read_nothing_from_a_run_without_a_card():
    cell = tiny.cell("paper-t1.cold")
    r, out, _numbers, _sample = run.run_cell(cell, 2147483907, 0.1, True,
                                             "cpu")
    assert out["correct"] and r.counters["family_launches"] > 0
    got = spec.read_metrics(cell.per_layer, r)
    assert not set(K2_READERS) & set(got)
    assert "cuda.marshal_us_per_cell" in got


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_k2_global_time_a_step_agrees_with_the_device_trace(card):
    """A short traced ``paper-t1.cold`` run: K2's time a step from the
    program's timing events is within 3 % of torch.profiler's."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "warpbench", "--workload", "paper-t1.cold",
         "--seed", "2147483911", "--seconds", "3", "--trace", "1"],
        cwd=str(spec.ROOT), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    events = metrics["k2.global_ns_per_step"]["value"]
    trace = metrics["k2.ns_per_step"]["value"]
    assert abs(events / trace - 1) < 0.03, (events, trace)
