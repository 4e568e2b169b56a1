#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          (from the root of a checkout)

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the family kernels from ``src/repro_torch/.../csrc`` (nvcc).
3. Holds K1 (``ws_prep_kernel``) against ``prep_ref`` on the same card
   tensors, and K2 (``ws_family_kernel``) against ``simulate_family_ref``
   run on the host CPU, on every one of the main path's 45 trace families
   (the paper grid, seeds 0-2, default sizes): exact equality per unit.
4. Holds K2 against ``simulate_family_ref`` once more on the 15 benchmarks
   x the paper suite at 256 threads, plus three odd geometries (3/5 SMs,
   3/5/7 controllers, 3/5/6-way L1s): exact equality per unit.
5. Drives the main path, ``Session(device="cuda").run(Study(seeds=(0, 1,
   2), engine="cuda"))`` (270 cells), with every launch count set to 0
   just before and read just after, and holds every record bit for bit
   against the reference grid file
   ``src/repro_torch/core/warpsim/data/paper_grid_seeds012.json``. A
   second run of the same study under torch.profiler gives that run's
   wall time, device busy time and idle share.
6. Prints the paper's headline table.
7. Times each kernel per seed-0 family (warm-up first) by
   torch.profiler's device time, which is the JSON ``ms``, and prints
   CUDA events over back-to-back wrapper calls (launch overhead included)
   as a column of its own, beside the plain version and the bound.

Prints one JSON object of kernel records on the line before the last and
``{"ok": true, "device": ...}`` as the last line. Exits non-zero, printing
no result, without a CUDA device, outside a checkout, or on any mismatch.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the "FP64" row
# (outside the tensor cores), which the kernels' double arithmetic is
# counted against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 34e12
GRID_FILE = os.path.join(ROOT, "src", "repro_torch", "core", "warpsim",
                         "data", "paper_grid_seeds012.json")
SOURCE = "src/repro_torch/core/warpsim/csrc/warpsim_family.cu"
REPLACES = {"ws_prep_kernel": "src/repro/core/warpsim/_pallas.py:192",
            "ws_family_kernel": "src/repro/core/warpsim/_pallas.py:233"}


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def family_units(warpsim, bench, n_threads, seed, cfgs):
    """Host stages of one trace family: one ThreadTrace, one WarpStream per
    expansion key, then the (StreamCols, cfg) units of its launch."""
    wl = warpsim.trace.get_workload(bench, n_threads=n_threads, seed=seed)
    tr = warpsim.divergence.build_thread_trace(wl)
    cols = {}
    units = []
    for cfg in cfgs:
        key = cfg.expansion_key()
        if key not in cols:
            cols[key] = warpsim._cuda.stream_cols(
                warpsim.divergence.aggregate_stream(tr, cfg))
        units.append((cols[key], cfg))
    return units


def k1_bytes_ops(fam):
    n = fam.blocks.numel()
    # blocks + nbytes in, ctrl + si + ssvc out; a divide and a multiply.
    tables = 8 * (fam.up.numel() + fam.fp.numel())
    return 16 * n + 24 * n + tables, 2 * n


def k2_bytes_ops(fam):
    n_blk = fam.blocks.numel()
    n_ops = fam.issue.numel()
    n_warps = fam.next0.numel()
    tables = 8 * (fam.up.numel() + fam.fp.numel())
    # next0/end per warp; issue/kind/blk_off/blk_len per op; slot/ctrl/si/
    # ssvc per block; cycles + 3 counts out per unit. About three double
    # operations per op and four per block.
    byts = (tables + 16 * n_warps + 25 * n_ops + 32 * n_blk
            + 32 * fam.n_units)
    return byts, 3 * n_ops + 4 * n_blk


def bound_ms(byts, ops):
    t_bytes = byts / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def profiled_ms(torch, fn, kernel, reps, attempts=5):
    """Mean device time per launch of `kernel` over `reps` calls of `fn`,
    from torch.profiler. A trace now and then comes back without the
    kernel's device records, so up to `attempts` traces are taken; None
    when none of them has any."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle.
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total += getattr(evt, "device_time_total",
                                 getattr(evt, "cuda_time_total", 0.0))
                count += evt.count
        if count > 0 and total > 0.0:
            return total / count / 1e3
    return None


def profiled_run(torch, fn):
    """Run `fn` once under torch.profiler. Returns the run's wall time (s,
    host clock, ending in a synchronize) and its device time (ms) by kernel
    or copy name (self times, so nothing is counted twice)."""
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        if t > 0:
            out[evt.key] = out.get(evt.key, 0.0) + t / 1e3
    return wall, out


def check_families(warpsim, fams, err):
    """Hold K1 against prep_ref (on the card) and K2 against
    simulate_family_ref (on the host CPU) on each ``(units, family)`` of
    `fams`, exactly; folds the largest difference into `err`. Returns the
    host-clock ms of simulate_family_ref per family."""
    import torch
    _cuda = warpsim._cuda
    plain_ms = {}
    for key, (units, fam) in fams.items():
        got = _cuda.prep(fam)
        want = _cuda.prep_ref(fam.up, fam.fp, fam.blocks, fam.nbytes)
        for g, w in zip(got, want):
            d = (g.double() - w.double()).abs().max().item()
            err["ws_prep_kernel"] = max(err["ws_prep_kernel"], d)
            if not torch.equal(g, w):
                fail(f"K1 differs from prep_ref on {key} (max {d})")
        cycles, counts = _cuda.simulate_family(fam, *got)
        cpu = _cuda.marshal(units, "cpu")
        cpu_prep = _cuda.prep_ref(cpu.up, cpu.fp, cpu.blocks, cpu.nbytes)
        t0 = time.perf_counter()
        w_cyc, w_cnt = _cuda.simulate_family_ref(cpu, *cpu_prep)
        plain_ms[key] = 1e3 * (time.perf_counter() - t0)
        cycles, counts = cycles.cpu(), counts.cpu()
        d = max((cycles - w_cyc).abs().max().item(),
                (counts - w_cnt).abs().max().item())
        err["ws_family_kernel"] = max(err["ws_family_kernel"], d)
        if not (torch.equal(cycles, w_cyc) and torch.equal(counts, w_cnt)):
            fail(f"K2 differs from simulate_family_ref on {key} "
                 f"{[c.name for _, c in units]}: {cycles.tolist()} "
                 f"{counts.tolist()} vs {w_cyc.tolist()} {w_cnt.tolist()}")
    return plain_ms


def event_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device: nothing to run")
    import repro_torch.core.warpsim as warpsim
    from repro_torch.core.warpsim import _cuda, api, machines
    from repro_torch.core.warpsim.trace import BENCHMARKS

    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.3f} s -> "
          f"{os.path.relpath(lib_path, ROOT)}")

    suite = list(machines.paper_suite().values())
    err = {k: 0.0 for k in _cuda.KERNELS}

    # ---- K1 and K2 against their plain versions on the main path's
    # ---- 45 trace families (paper grid, seeds 0-2, default sizes) ------
    fams = {}
    for seed in (0, 1, 2):
        for bench in BENCHMARKS:
            units = family_units(warpsim, bench, None, seed, suite)
            fams[(bench, seed)] = (units, _cuda.marshal(units, dev))
    plain_ms = check_families(warpsim, fams, err)
    torch.cuda.synchronize()
    print(f"K1 == prep_ref and K2 == simulate_family_ref (host CPU) on the "
          f"main path's {len(fams)} families "
          f"({sum(f.n_units for _, f in fams.values())} units, "
          f"{sum(f.blocks.numel() for _, f in fams.values())} blocks)")

    # ---- K2 at 256 threads and on odd geometries -------------------------
    odd = [machines.baseline(16, num_sms=3, num_mem_ctrls=5, l1_ways=3,
                             l1_size_bytes=64 * 3 * 7),
           machines.sw_plus(num_sms=5, num_mem_ctrls=3, l1_ways=5,
                            l1_size_bytes=64 * 5 * 11),
           machines.lw_plus(num_sms=3, num_mem_ctrls=7, l1_ways=6,
                            l1_size_bytes=64 * 6 * 13)]
    small = {}
    for i, cfgs in enumerate((suite, odd)):
        for bench in BENCHMARKS:
            units = family_units(warpsim, bench, 256, 0, cfgs)
            small[(bench, 256, i)] = (units, _cuda.marshal(units, dev))
    check_families(warpsim, small, err)
    print(f"K1, K2 == plain versions on "
          f"{sum(f.n_units for _, f in small.values())} more units: "
          f"15 benches x (paper suite, 3 odd geometries), 256 threads")
    del small

    # ---- the main path ---------------------------------------------------
    with open(GRID_FILE, encoding="utf-8") as fh:
        ref = json.load(fh)["records"]
    study = api.Study(seeds=(0, 1, 2), engine="cuda")
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = api.Session(device=dev).run(study)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _cuda.launch_count(k) for k in _cuda.KERNELS}
    if len(res.records) != 270 or len(ref) != 270:
        fail(f"{len(res.records)} records, {len(ref)} in the grid file")
    bad = 0
    for rec, want in zip(res.records, ref):
        got = dataclasses.asdict(rec.result)
        exp = {k: float.fromhex(v) if isinstance(v, str)
               and k not in ("name", "machine") else v
               for k, v in want["result"].items()}
        coords = (rec.machine, rec.bench, rec.seed, rec.n_threads)
        if coords != (want["machine"], want["bench"], want["seed"],
                      want["n_threads"]) or got != exp \
                or not math.isfinite(got["cycles"]):
            bad += 1
            if bad <= 3:
                print(f"  mismatch {coords}: {got} != {exp}")
    if bad:
        fail(f"{bad} of 270 records differ from the reference grid")
    if res.stats["family_launches"] != 45:
        fail(f"family_launches {res.stats['family_launches']} != 45")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")
    print(f"main path: 270 records == reference grid (bit for bit); "
          f"stats {res.stats}; launches {launches}")
    print(f"main path wall: {wall:.3f} s for 270 cells "
          f"(host stages + 45 family launches) [{card}]")

    # ---- where the device time goes: a second run, traced ----------------
    t_wall, parts = profiled_run(
        torch, lambda: api.Session(device=dev).run(study))
    busy = sum(parts.values())
    print(f"traced second run: wall {1e3 * t_wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / (1e3 * t_wall):.4f} (both "
          f"from this run, under torch.profiler) [{card}]")
    for key, ms in sorted(parts.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:10.3f} ms  {key[:70]}")

    # ---- headline table --------------------------------------------------
    print("headline (mean [min, max] over seeds 0-2):")
    for metric, band in res.bands().items():
        print(f"  {metric:40s} {band['mean']:.6f} "
              f"[{band['min']:.6f}, {band['max']:.6f}]")

    # ---- timing per family (seed 0) ---------------------------------------
    rows = {k: [] for k in _cuda.KERNELS}
    print(f"per-family times, ms per launch [{card}]:")
    print(f"  {'bench':5s} {'units':>5s} {'warps':>6s} {'ops':>7s} "
          f"{'blocks':>7s} | {'K1 dev':>8s} {'K1 ev':>8s} {'plain':>8s} "
          f"{'bound':>8s} | {'K2 dev':>8s} {'K2 ev':>8s} {'plain':>8s} "
          f"{'bound':>8s}")
    for bench in BENCHMARKS:
        _units, fam = fams[(bench, 0)]
        ctrl, si, ssvc = _cuda.prep(fam)          # warm-up
        _cuda.simulate_family(fam, ctrl, si, ssvc)
        torch.cuda.synchronize()

        def k1():
            _cuda.prep(fam)

        def k1_plain():
            _cuda.prep_ref(fam.up, fam.fp, fam.blocks, fam.nbytes)

        def k2():
            _cuda.simulate_family(fam, ctrl, si, ssvc)

        k1_ev = event_ms(torch, k1, 20)
        k2_ev = event_ms(torch, k2, 3)
        k1_dev = profiled_ms(torch, k1, "ws_prep_kernel", 20)
        k2_dev = profiled_ms(torch, k2, "ws_family_kernel", 3)
        k1_plain_ms = event_ms(torch, k1_plain, 20)
        b1, by1 = bound_ms(*k1_bytes_ops(fam))
        b2, by2 = bound_ms(*k2_bytes_ops(fam))
        for name, dev_ms, p_ms, bnd, by in (
                ("ws_prep_kernel", k1_dev, k1_plain_ms, b1, by1),
                ("ws_family_kernel", k2_dev, plain_ms[(bench, 0)], b2, by2)):
            if dev_ms is not None:
                rows[name].append((dev_ms, p_ms, bnd, by))
        print(f"  {bench:5s} {fam.n_units:5d} {fam.next0.numel():6d} "
              f"{fam.issue.numel():7d} {fam.blocks.numel():7d} | "
              f"{k1_dev or math.nan:8.4f} {k1_ev:8.4f} {k1_plain_ms:8.4f} "
              f"{b1:8.6f} | {k2_dev or math.nan:8.3f} {k2_ev:8.3f} "
              f"{plain_ms[(bench, 0)]:8.1f} {b2:8.6f}")
    print("  dev: device time per launch from torch.profiler (nan: no "
          "device record in 5 traces; that family is left out of the JSON "
          "means); ev: CUDA events over back-to-back wrapper calls (20 for "
          "K1, 3 for K2), launch overhead included, not used in the JSON; "
          "K1 plain: prep_ref on the card, CUDA events; K2 plain: "
          "simulate_family_ref on the host CPU, host clock; bound: bytes "
          "read once and written once over 3.35 TB/s")
    for name, r in rows.items():
        if not r:
            fail(f"torch.profiler recorded no device time for {name}")
        print(f"  {name}: JSON means over the {len(r)} of 15 families with "
              f"a device record")

    kernels = []
    for name in _cuda.KERNELS:
        r = rows[name]
        n = len(r)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name],
            "ms": sum(x[0] for x in r) / n,
            "plain_ms": sum(x[1] for x in r) / n,
            "bound_ms": sum(x[2] for x in r) / n,
            "bound_by": r[0][3],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
