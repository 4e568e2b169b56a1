"""The port's examples at their smoke sizes on the CPU (``--device cpu``),
each as a user runs it (``main``), with what its reference example shows:

* ``quickstart``: the two-benchmark study's IPCs equal the reference's
  grid for the same cells (records bit for bit), and the tiny training
  run's loss falls;
* ``serve_batched``: 8 requests served in fused decode steps;
* ``train_resume``: the run killed at step 12 and resumed gives the
  losses of steps 12-23 of an uninterrupted run, bit for bit;
* ``warpsize_study``: the paper suite and the dense sweep, cold then warm
  (a second run simulates nothing), and the suite's records saved.

Their runs on a card are the ``gpu`` tests of ``test_torch_harness.py``.
"""

import dataclasses
import json
import os

import pytest
import torch

from repro_torch.core.warpsim import machines as tmachines
from repro_torch.core.warpsim import runner as trunner
from repro_torch.examples import (quickstart, serve_batched, train_resume,
                                  warpsize_study)
from repro_torch.launch import train as ttrain

try:
    from repro.core.warpsim import machines as rmachines
    from repro.core.warpsim import runner as rrunner
except ImportError:     # a machine with a card and no jax
    rrunner = None


def test_quickstart(capsys):
    losses = quickstart.main(["--device", "cpu"])
    assert len(losses) == quickstart.STEPS
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "SW+" in out and "step  19" in out
    if rrunner is None:
        return
    want = rrunner.run_suite(rmachines.paper_suite(), benches=("BKP", "MU"))
    got = trunner.run_suite(tmachines.paper_suite(), benches=("BKP", "MU"),
                            device="cpu")
    for m in want:
        for b in want[m]:
            assert dataclasses.asdict(got[m][b]) == dataclasses.asdict(
                want[m][b])


def test_serve_batched():
    stats = serve_batched.main(["--device", "cpu"])
    assert stats["requests"] == 8
    assert stats["total_new_tokens"] == 8 * 12
    assert stats["decode_steps"] > 0


def test_train_resume_continues_the_uninterrupted_run(tmp_path):
    resumed = train_resume.main(["--device", "cpu", "--work-dir",
                                 str(tmp_path)])
    assert os.listdir(tmp_path) == []          # the drill's checkpoints go
    whole = ttrain.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                         "24", "--batch", "4", "--seq-len", "64",
                         "--log-every", "24", "--device", "cpu"])
    assert resumed["final_step"] == 24
    assert resumed["losses"] == whole["losses"][12:]


def test_warpsize_study_cold_then_warm(tmp_path):
    cache = str(tmp_path / "sweep_cache")
    cold = warpsize_study.main(["--device", "cpu", "--cache-dir", cache])
    assert cold["study"]["simulated"] == 90
    assert cold["dense"]["cells"] == 90
    warm = warpsize_study.main(["--device", "cpu", "--cache-dir", cache])
    assert warm["study"]["simulated"] == 0
    assert warm["study"]["cache_hits"] == 90
    assert warm["summary"] == cold["summary"]
    with open(tmp_path / "warpsim_suite.json") as fh:
        suite = json.load(fh)
    assert set(suite) == set(tmachines.paper_suite())


@pytest.mark.parametrize("module", [quickstart, serve_batched, train_resume,
                                    warpsize_study])
def test_examples_default_to_the_card(module, tmp_path):
    """Without ``--device cpu`` an example asks for the card, and a host
    without one refuses (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu tests run the examples")
    argv = ["--cache-dir", str(tmp_path)] if module is warpsize_study else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
