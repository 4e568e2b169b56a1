"""Sweep-service smoke of the port: daemon up, figures cold + warm, zero
re-simulation, in-flight dedup, metrics.

1. start ``python -m repro_torch.core.warpsim.service`` on an ephemeral
   port with a throwaway cache dir, on `--device` (the card by default;
   ``--device cpu`` runs the kernel's plain version);
2. run the port's figures against it **cold** (``WARPSIM_SERVICE_URL``
   set in the child's environment, picked up by ``api.Session.from_env``
   inside ``repro_torch.benchmarks.figs``) — everything simulates, on the
   daemon;
3. run the same figures **warm** and check via ``GET /stats`` that the
   pass simulated **zero** cells and took **zero** result-cache misses;
4. fire two concurrent ``GET /cell`` requests for one *uncomputed* cell
   and check that exactly one simulation happened (in-flight dedup,
   observed end to end over HTTP);
5. scrape ``GET /metrics`` and check that it parses as Prometheus text
   exposition whose ``warpsim_cells_simulated_total`` matches the
   ``/stats`` counter.

On the card the daemon's ``/healthz`` must report engine ``cuda``, and
its ``ws_family_kernel`` launches must grow by one per simulated cell.
The module also holds what the fleet smokes (``chaos_smoke``,
``mesh_smoke``, ``obs_smoke``) share: their study, in-process daemons,
the health check and the launch contract.
Exit code 0 iff every check holds::

    PYTHONPATH=src python -m repro_torch.benchmarks.service_smoke \\
        [--device cpu] [--figs fig2,fig4,fig7]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Mapping, Optional

import torch

from repro_torch.core.warpsim import _cuda, api, envcfg, machines
from repro_torch.core.warpsim.mesh import MeshConfig
from repro_torch.core.warpsim.obs import parse_exposition
from repro_torch.core.warpsim.service import (
    ResilientClient, SweepService, serve,
)

REPO = str(Path(__file__).resolve().parents[3])
DEFAULT_FIGS = "fig2,fig4,fig7"
# The fleet smokes' study (the reference harnesses'): BFS and DYN on ws8
# and SW+ at 128 threads.
SMALL = dict(benches=("BFS", "DYN"), n_threads=128)
# The meshed fleets' replication factor (the reference harnesses').
REPLICATION = 2


class SmokeFailure(RuntimeError):
    """A check of the smoke did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _get(url: str, timeout: float = 600.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _get_text(url: str, timeout: float = 60.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.headers.get("Content-Type", ""), resp.read().decode()


def child_env(url: str = "",
              extra: Optional[Mapping[str, str]] = None) -> dict:
    """The environment of a child of this harness: ``src`` on the path,
    the daemon's URL (or none) for ``Session.from_env``, and `extra`, a
    mapping of registered ``WARPSIM_*`` variables (a daemon's fault plan,
    the way an operator injects one)."""
    unknown = sorted(set(extra or ()) - set(envcfg.REGISTRY))
    if unknown:
        raise ValueError(f"unregistered variables for a child: {unknown}")
    env = dict(os.environ)
    env["WARPSIM_SERVICE_URL"] = url
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.update(extra or {})
    return env


def launches(url: str) -> int:
    """The daemon's ``ws_family_kernel`` launches so far (``/healthz``)."""
    return int(_get(url + "/healthz")["cuda"]["launches"]["ws_family_kernel"])


def small_study(**kw) -> api.Study:
    """The fleet smokes' study: ``SMALL`` on ws8 and SW+, with `kw`."""
    base = dict(machines={"ws8": machines.baseline(8),
                          "SW+": machines.sw_plus()}, **SMALL)
    base.update(kw)
    return api.Study(**base)


def noop_sleep(_seconds) -> None:
    """A client's backoff that does not wait."""


@contextlib.contextmanager
def daemon(svc):
    """`svc` (a ``SweepService``) served by a thread of this process on an
    ephemeral port; yields its URL."""
    httpd = serve(svc)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield "http://%s:%d" % httpd.server_address[:2]
    finally:
        httpd.shutdown()
        httpd.server_close()


def fleet_client(urls) -> ResilientClient:
    """The fleet smokes' client over `urls`: retries and fails over
    without waiting, its breaker never opening."""
    return ResilientClient(urls, max_retries=8, breaker_threshold=99,
                           seed=0, sleep=noop_sleep, timeout=120.0)


@contextlib.contextmanager
def mesh_fleet(tmp, tag, members, device="cuda", fault_plans=None):
    """`members` meshed daemons of this process on `device` over disjoint
    roots `tmp`/`tag`-N at ``REPLICATION``; `fault_plans`, one a member
    or ``None``. Yields the services and their URLs."""
    plans = fault_plans or (None,) * members
    svcs = [SweepService(f"{tmp}/{tag}-{i}", device=device,
                         persist_traces=False, mesh=False,
                         fault_plan=plans[i])
            for i in range(members)]
    with contextlib.ExitStack() as stack:
        urls = [stack.enter_context(daemon(s)) for s in svcs]
        for svc, url in zip(svcs, urls):
            svc.configure_mesh(
                MeshConfig.build(url, urls, replication=REPLICATION))
            check_health(url, device)
        yield svcs, urls


def check_health(url: str, device) -> dict:
    """The daemon at `url` is up and computes on `device`: engine ``cuda``
    on the card, ``torch`` (the kernel's plain version) on the CPU."""
    health = _get(url + "/healthz")
    want = (_cuda.resolve_engine("auto", device), str(torch.device(device)))
    got = (health["engine"], health["device"])
    check(health["ok"] and got == want,
          f"{url}/healthz: engine, device {got}, expected {want}")
    return health


def kernel_launches() -> int:
    """This process's ``ws_family_kernel`` launches so far. Every daemon
    and worker of the process counts into this one number, so a scenario
    reads it as a delta."""
    return _cuda.launch_count("ws_family_kernel")


def check_launches(label: str, launched: int, simulated: int,
                   device) -> int:
    """One one-unit ``ws_family_kernel`` launch a simulated cell on the
    card, none on the CPU; returns `launched`."""
    want = simulated if torch.device(device).type == "cuda" else 0
    check(launched == want,
          f"{label}: {launched} ws_family_kernel launches for {simulated} "
          f"simulated cells on {device}")
    return launched


@contextlib.contextmanager
def boot_daemon(cache_dir: str, device: str = "cuda",
                engine: str = "auto", boot_timeout: float = 300.0,
                extra_env: Optional[Mapping[str, str]] = None):
    """A daemon subprocess on an ephemeral port; yields its URL.

    `extra_env` goes to the child's environment (:func:`child_env`).
    Reads the listening line from its output (skipping any warnings
    before it) and stops the daemon on exit, killing it if it does not
    stop within 10 s.
    """
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.warpsim.service",
         "--port", "0", "--cache-dir", cache_dir, "--device", device,
         "--engine", engine],
        env=child_env(extra=extra_env), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        seen = []
        deadline = time.monotonic() + boot_timeout
        while time.monotonic() < deadline:
            line = daemon.stdout.readline()
            if not line:
                break
            seen.append(line)
            m = re.search(r"listening on (http://[0-9.]+:\d+)", line)
            if m:
                url = m.group(1)
                break
        check(url is not None,
              "daemon never printed its listening URL:\n" + "".join(seen))
        yield url
    finally:
        daemon.terminate()
        try:
            daemon.wait(10)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait(10)
        daemon.stdout.close()


def _run_figs(url: str, figs: str, device: str) -> None:
    subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.figs",
                    "--only", figs, "--device", device],
                   env=child_env(url), cwd=REPO, check=True, timeout=1200,
                   stdout=subprocess.DEVNULL)


def dedup_check(url: str, cell_query: str, strict: bool = False) -> dict:
    """Two concurrent ``GET /cell`` for one uncomputed cell, sent together
    (a barrier), must make exactly one simulation. The second is served
    by the first's in-flight simulation (a dedup wait), or, unless
    `strict`, from the cache when it arrived after the first finished.
    Returns the counter deltas and how each was served."""
    before = _get(url + "/stats")["counters"]
    cell_url = url + "/cell?" + cell_query
    barrier = threading.Barrier(2)

    def fetch(_):
        barrier.wait(60)
        return _get(cell_url)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        a, b = pool.map(fetch, range(2))
    check(a["result"] == b["result"], "dedup: the two answers differ")
    after = _get(url + "/stats")["counters"]
    delta = {k: after[k] - before[k]
             for k in ("simulated", "dedup_waits", "cache_hits")}
    check(delta["simulated"] == 1,
          f"dedup: {delta['simulated']} simulations for one cell")
    served = sorted((a["source"], b["source"]))
    allowed = [["dedup", "simulated"]] + ([] if strict
                                          else [["cache", "simulated"]])
    check(served in allowed and delta["dedup_waits"] == (
        served[0] == "dedup"), f"dedup: served as {served}, {delta}")
    delta["served"] = served
    return delta


def metrics_check(url: str) -> dict:
    """``/metrics`` parses, and its simulated-cell counter is ``/stats``'."""
    ctype, text = _get_text(url + "/metrics")
    check(ctype.startswith("text/plain"), f"/metrics content type {ctype}")
    check("# TYPE warpsim_cells_simulated_total counter" in text,
          "/metrics lacks warpsim_cells_simulated_total")
    samples = parse_exposition(text)
    stats_sim = _get(url + "/stats")["counters"]["simulated"]
    check(samples["warpsim_cells_simulated_total"] == stats_sim,
          f"/metrics {samples['warpsim_cells_simulated_total']} != /stats "
          f"{stats_sim}")
    check(samples.get('warpsim_stage_seconds_count{stage="engine"}', 0) > 0,
          "no engine stage observed")
    return samples


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.service_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the daemon's device: cuda (default) or cpu")
    ap.add_argument("--figs", default=DEFAULT_FIGS,
                    help="comma-separated figure names to drive")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"

    with tempfile.TemporaryDirectory(prefix="warpsim-torch-smoke-") as tmp, \
            boot_daemon(tmp, device=args.device) as url:
        health = _get(url + "/healthz")
        check(health["ok"], f"healthz: {health}")
        check(health["engine"] == ("cuda" if on_card else "torch"),
              f"healthz engine {health['engine']} on {args.device}")
        print(f"service-smoke: daemon at {url}, engine={health['engine']}, "
              f"device={health['device']}")

        n0 = launches(url)
        t0 = time.perf_counter()
        _run_figs(url, args.figs, args.device)
        cold = _get(url + "/stats")
        cold_sim = cold["counters"]["simulated"]
        check(cold_sim > 0, "the cold figure pass simulated nothing")
        n_cold = launches(url) - n0
        if on_card:
            check(n_cold == cold_sim,
                  f"{n_cold} kernel launches for {cold_sim} simulated cells")
        print(f"service-smoke: cold pass {time.perf_counter() - t0:.3f} s, "
              f"{cold_sim} cells simulated, {n_cold} ws_family_kernel "
              f"launches, {cold['result_cache']['entries']} cached")

        t0 = time.perf_counter()
        _run_figs(url, args.figs, args.device)
        warm = _get(url + "/stats")
        warm_sim = warm["counters"]["simulated"] - cold_sim
        warm_misses = (warm["result_cache"]["misses"]
                       - cold["result_cache"]["misses"])
        n_warm = launches(url) - n0 - n_cold
        check(warm_sim == 0, f"the warm pass re-simulated {warm_sim} cells")
        check(warm_misses == 0, f"the warm pass took {warm_misses} misses")
        check(n_warm == 0, f"the warm pass launched {n_warm} times")
        print(f"service-smoke: warm pass {time.perf_counter() - t0:.3f} s, "
              f"0 cells simulated, 0 cache misses, 0 launches")

        delta = dedup_check(url, "bench=BFS&machine=ws32&seed=12345"
                                 "&n_threads=256")
        print(f"service-smoke: concurrent cold cell -> 1 simulation "
              f"(served as {delta['served']}, dedup_waits "
              f"+{delta['dedup_waits']})")

        samples = metrics_check(url)
        print(f"service-smoke: /metrics valid, {len(samples)} samples, "
              f"warpsim_cells_simulated_total="
              f"{int(samples['warpsim_cells_simulated_total'])} "
              f"(== /stats counters.simulated)")
    print("service-smoke OK")


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        sys.exit(f"service-smoke: FAIL: {e}")
