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

from repro_torch.core.warpsim.obs import parse_exposition

REPO = str(Path(__file__).resolve().parents[3])
DEFAULT_FIGS = "fig2,fig4,fig7"


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


def child_env(url: str = "") -> dict:
    """The environment of a child of this harness: ``src`` on the path,
    and the daemon's URL (or none) for ``Session.from_env``."""
    env = dict(os.environ)
    env["WARPSIM_SERVICE_URL"] = url
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return env


def launches(url: str) -> int:
    """The daemon's ``ws_family_kernel`` launches so far (``/healthz``)."""
    return int(_get(url + "/healthz")["cuda"]["launches"]["ws_family_kernel"])


@contextlib.contextmanager
def boot_daemon(cache_dir: str, device: str = "cuda",
                engine: str = "auto", boot_timeout: float = 300.0):
    """A daemon subprocess on an ephemeral port; yields its URL.

    Reads the listening line from its output (skipping any warnings
    before it) and stops the daemon on exit, killing it if it does not
    stop within 10 s.
    """
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.warpsim.service",
         "--port", "0", "--cache-dir", cache_dir, "--device", device,
         "--engine", engine],
        env=child_env(), cwd=REPO, stdout=subprocess.PIPE,
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
