"""A study's K2 family launches side by side on a pool of streams.

* On the CPU: a launch has finished when it returns, the pool is of no
  streams and no SM bound; ``warpsim_k2_beside``'s count takes only the
  unfinished launches of other streams, and forgets the finished ones.
* On a card (``gpu``-marked, skipping without one): a study at the
  paper's 16 SMs gives the records of the same study on one stream and
  of the ``native`` host engine, bit for bit, with launches side by
  side; a one-unit launch of the service's path has none beside it.
  ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_family_streams.py``.

This file imports no JAX: the card's tests compare the port with itself
and with its host engine.
"""

import dataclasses
import sys

import pytest
import torch

from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim import api
from repro_torch.core.warpsim import divergence
from repro_torch.core.warpsim import machines
from repro_torch.core.warpsim import obs
from repro_torch.core.warpsim import sweep
from repro_torch.core.warpsim import trace


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_launches_beside_count_unfinished_launches_of_other_streams(
        monkeypatch):
    flight = [(1, _Event(False)), (2, _Event(False)), (2, _Event(True)),
              (3, _Event(True)), (3, _Event(False))]
    monkeypatch.setattr(_cuda, "_IN_FLIGHT", list(flight))
    assert _cuda._launches_beside(2) == 2
    assert _cuda._IN_FLIGHT == [flight[0], flight[1], flight[4]]
    assert _cuda._launches_beside(4) == 3
    flight[0][1].done = flight[4][1].done = True
    assert _cuda._launches_beside(1) == 1
    assert _cuda._IN_FLIGHT == [flight[1]]


def test_cpu_launches_finish_before_they_return():
    streams, max_units = _cuda.launch_streams("cpu")
    assert streams == [None] * _cuda.K2_STREAMS and max_units == sys.maxsize
    wl = trace.get_workload("BFS", n_threads=128, seed=0)
    cfg = machines.baseline(8)
    launch = _cuda.launch_family([(divergence.expand_stream(wl, cfg), cfg)],
                                 device="cpu")
    assert launch.done is None and launch.finished()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _records(res):
    return [dataclasses.asdict(r) for r in res.records]


@pytest.mark.gpu
def test_side_by_side_launches_give_one_streams_and_natives_records(
        card, monkeypatch):
    """Five families of six units at 16 SMs and 16,384 threads: with the
    traces and streams built by a first run, the host only marshals, and
    each launch finds the earlier ones still running on other streams.
    The records equal, bit for bit, those of a pool of one stream (whose
    launches have none beside them) and of the ``native`` engine."""
    cfgs = {name: dataclasses.replace(cfg, num_sms=16)
            for name, cfg in machines.paper_suite().items()}
    study = api.Study(benches=("BFS", "BKP", "MTM", "DYN", "SR2"),
                      machines=cfgs, n_threads=16384, seeds=(2147483907,),
                      engine="cuda")
    session = api.Session(device=card)
    session.run(study)
    side_obs, one_obs, cell_obs = (obs.Observability() for _ in range(3))
    with obs.bind(side_obs):
        side = session.run(study)
    monkeypatch.setattr(_cuda, "K2_STREAMS", 1)
    with obs.bind(one_obs):
        one = session.run(study)
    native = session.run(dataclasses.replace(study, engine="native"),
                         backend=api.InProcessBackend(parallel=False))
    assert side.stats["family_launches"] == one.stats["family_launches"] == 5
    assert _records(side) == _records(one) == _records(native)
    beside = side_obs.registry.snapshot()["warpsim_k2_beside"]
    assert beside[".count"] == 5 and beside[".sum"] > 0
    assert one_obs.registry.snapshot()["warpsim_k2_beside"] == {
        ".sum": 0.0, ".count": 5}
    with obs.bind(cell_obs):
        cell = sweep.compute_cell("BFS", cfgs["SW+"], n_threads=16384,
                                  seed=2147483907, engine="cuda",
                                  device=card)
    assert cell_obs.registry.snapshot()["warpsim_k2_beside"] == {
        ".sum": 0.0, ".count": 1}
    assert dataclasses.asdict(cell) == dataclasses.asdict(
        side.by(machine="SW+", bench="BFS").one())
