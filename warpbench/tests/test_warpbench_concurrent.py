"""K2's launches side by side, read from the program's own registry."""

import pytest

from warpbench import run, spec
from warpbench.tests import tiny

METRIC = "k2.concurrent_launches"


def test_concurrent_launches_are_the_histograms_mean(monkeypatch):
    from repro_torch.core.warpsim import _cuda, obs
    ob = obs.Observability()
    monkeypatch.setattr(obs, "default", lambda: ob)
    assert spec.reader(METRIC)(None) is None
    for beside in (0, 2, 3, 1):
        _cuda.k2_beside(ob).observe(beside)
    assert spec.reader(METRIC)(None) == pytest.approx(1.5)


def test_concurrent_launches_read_nothing_from_a_run_without_a_card(
        monkeypatch):
    from repro_torch.core.warpsim import obs
    monkeypatch.setattr(obs, "default", lambda: obs.Observability())
    cell = tiny.cell("paper-t1.cold")
    r, out, _numbers, _sample = run.run_cell(cell, 2147483923, 0.1, True,
                                             "cpu")
    assert out["correct"] and r.counters["family_launches"] > 0
    assert METRIC in [m["name"] for m in cell.per_layer]
    got = spec.read_metrics(cell.per_layer, r)
    assert METRIC not in got and "cuda.marshal_us_per_cell" in got
