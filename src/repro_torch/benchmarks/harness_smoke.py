"""Checks of the benchmark harness, the dry run and the examples on a card.

``chip_smoke.py``'s harness phase and the ``gpu`` tests of
``tests/test_torch_harness.py`` call these; each raises AssertionError
on a failure:

* :func:`moe_check` (a): ``moe_dispatch_bench.run("cuda")`` with the
  launch counts set to 0 just before and read just after (K3 once and K4
  three times a SW+ call); then each router's case on the card and on
  the host CPU from the same inputs: each strategy's output against the
  dense oracle (LW+'s with the assignments it drops left out) within K4's
  float32 tolerance, and the slot efficiencies and drop rate equal to
  the CPU's unless top-k choices flipped at near ties, which are counted;
* :func:`sweep_check` (b): ``sweep_bench.run(quick=True)``, which asserts
  one ``ws_family_kernel`` launch a family cold, none warm, records bit
  for bit with the grid through ``engine="torch"`` and with its host
  baselines', and (on the card) the reference's quick floors on cold;
* :data:`DRYRUN` (c), :data:`RUN` (d), :func:`example_commands` (e): the
  command lines of the child processes (the dry run needs a process
  group of its own), started by :func:`start` and read by :func:`finish`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List

import torch

from repro_torch import kernels
from repro_torch.benchmarks import moe_dispatch_bench as bench
from repro_torch.benchmarks import sweep_bench
from repro_torch.benchmarks.service_smoke import child_env
from repro_torch.models import moe as moe_mod

#: K4's float32 tolerance (``tests/test_torch_kernels.py``): rtol, atol.
K4_TOL = (2e-5, 1.6e-4)
#: Router probabilities this close are a near tie: the card's float32
#: logits (other summation order) may pick either.
NEAR_TIE = 1e-5
#: (c): the dry-run cell, written to the default results file.
DRYRUN_CELL = ("tinyllama-1.1b", "train_4k", "single")
DRYRUN = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          DRYRUN_CELL[0], "--shape", DRYRUN_CELL[1], "--mesh",
          DRYRUN_CELL[2], "--force"]
RUN = [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
       "moe,roofline"]


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _flips(card_idx: torch.Tensor, cpu_idx: torch.Tensor,
           cpu_probs: torch.Tensor, k: int) -> int:
    """Tokens whose top-k (or its order) the card chose otherwise; each
    must be a near tie of two of the CPU's k + 1 largest probabilities."""
    rows = (card_idx != cpu_idx).any(-1).nonzero().flatten()
    top = torch.sort(cpu_probs[rows], dim=-1, descending=True).values
    gaps = (top[:, :k] - top[:, 1:k + 1]).amin(-1)
    _require(bool((gaps <= NEAR_TIE).all()),
             f"top-k differs from the CPU's away from a near tie: gaps "
             f"{gaps.tolist()}")
    return len(rows)


def moe_check(device) -> dict:
    """(a); returns the bench's rows, the launches, and per router the
    flips and the outputs' largest gap from the oracle."""
    kernels.reset_launch_counts()
    rows = bench.run(device)
    torch.cuda.synchronize(device)
    launches = {k: kernels.launch_count(k)
                for k in ("gather_rows_kernel", "gmm_kernel")}
    calls = len(bench.ROUTERS) * (1 + bench.REPS)
    _require(launches == {"gather_rows_kernel": calls,
                          "gmm_kernel": 3 * calls},
             f"moe_dispatch_bench launched {launches}, not K3 {calls} and "
             f"K4 {3 * calls} (once and three times a SW+ call)")
    cfg = bench._cfg()
    x, routers = bench.inputs(cfg)
    out = {"rows": rows, "launches": launches, "routers": {}}
    for label, params in routers.items():
        card = bench.case(params, x, cfg, device, reps=0)
        cpu = bench.case(params, x, cfg, "cpu", reps=0)
        flips = _flips(card["idx"], cpu["idx"], cpu["probs"],
                       cfg.moe_top_k)
        if not flips:
            _require(card["slot_eff"] == cpu["slot_eff"]
                     and card["drop_rate"] == cpu["drop_rate"],
                     f"{label}: slot efficiencies {card['slot_eff']} / drop "
                     f"rate {card['drop_rate']} on the card, "
                     f"{cpu['slot_eff']} / {cpu['drop_rate']} on the CPU")
        dev_params = {k: v.to(device) for k, v in params.items()}
        xd = x.to(device)
        kept = bench.lw_kept(cfg, card["idx"].to(device), x.shape[0])
        gaps = {}
        with torch.no_grad():
            for name, keep in (("lw_plus", kept), ("sw_plus", None)):
                want = moe_mod.dispatch_dense_oracle(
                    dev_params, xd, cfg, keep)[0].cpu()
                got = card["y"][name]
                ok = torch.allclose(got, want, rtol=K4_TOL[0],
                                    atol=K4_TOL[1])
                gaps[name] = float((got - want).abs().max())
                _require(ok, f"{label} {name}: max abs err {gaps[name]} "
                             f"from the dense oracle")
        out["routers"][label] = {
            "flips": flips, "max_abs_err": gaps,
            "slot_eff": card["slot_eff"], "drop_rate": card["drop_rate"],
            "cpu_slot_eff": cpu["slot_eff"],
            "cpu_drop_rate": cpu["drop_rate"]}
    return out


def sweep_check(device) -> List[tuple]:
    """(b): the quick sweep bench's rows (it asserts its contract)."""
    return sweep_bench.run(quick=True, device=device)


def example_commands(work: str) -> Dict[str, List[str]]:
    """(e): the four examples on the card, the study's cache and the
    drill's checkpoints under `work`."""
    mod = [sys.executable, "-m"]
    return {
        "quickstart": mod + ["repro_torch.examples.quickstart"],
        "serve_batched": mod + ["repro_torch.examples.serve_batched"],
        "train_resume": mod + ["repro_torch.examples.train_resume",
                               "--work-dir", work],
        "warpsize_study": mod + ["repro_torch.examples.warpsize_study",
                                 "--cache-dir",
                                 os.path.join(work, "sweep_cache")],
    }


def start(name: str, argv: List[str], cwd: str) -> dict:
    """A child process with ``src`` on its path and no sweep daemon named
    (``service_smoke.child_env``), its output captured to files in
    `cwd`."""
    out = open(os.path.join(cwd, name + ".out"), "w+")
    err = open(os.path.join(cwd, name + ".err"), "w+")
    proc = subprocess.Popen(argv, cwd=cwd, env=child_env(), stdout=out,
                            stderr=err)
    return {"proc": proc, "out": out, "err": err, "t0": time.perf_counter(),
            "argv": argv}


def finish(child: dict, timeout: float = 600) -> dict:
    """Wait for a child of :func:`start`; its exit code, output and wall
    (the child is killed at `timeout`)."""
    proc = child["proc"]
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    wall = time.perf_counter() - child["t0"]
    text = {}
    for key in ("out", "err"):
        child[key].seek(0)
        text[key] = child[key].read()
        child[key].close()
    return {"rc": rc, "stdout": text["out"], "stderr": text["err"],
            "wall_s": wall, "argv": child["argv"]}


def check_finished(name: str, result: dict) -> None:
    _require(result["rc"] == 0,
             f"{name}: exit {result['rc']}\n{result['stdout'][-2000:]}\n"
             f"{result['stderr'][-4000:]}")


def csv_rows(text: str) -> List[tuple]:
    """The ``name,us_per_call,derived`` rows of a harness's output."""
    lines = [ln for ln in text.splitlines() if ln.count(",") == 2]
    _require(bool(lines) and lines[0] == "name,us_per_call,derived",
             f"no CSV header in {text[-500:]!r}")
    return [(n, float(us), float(d)) for n, us, d in
            (ln.split(",") for ln in lines[1:])]
