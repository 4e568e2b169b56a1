#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          (from the root of a checkout)

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel from the ``csrc`` sources in the checkout, one
   ``nvcc`` per source, all started together: the family kernels (K1,
   K2) and the LM kernels (K3 ``gather_rows_kernel``, K4 ``gmm_kernel``),
   whose ``ptxas -v`` report (registers, shared memory, spills) it prints.
3. Holds K1 (``ws_prep_kernel``) against ``prep_ref`` on the same card
   tensors, and K2 (``ws_family_kernel``) against ``simulate_family_ref``
   run on the host CPU, on every one of the warp-size study's 45 trace
   families (the paper grid, seeds 0-2, default sizes): exact equality
   per unit.
4. Holds K2 against ``simulate_family_ref`` once more on the 15 benchmarks
   x the paper suite at 256 threads, plus three odd geometries (3/5 SMs,
   3/5/7 controllers, 3/5/6-way L1s): exact equality per unit.
5. Drives the study's path, ``Session(device="cuda").run(Study(seeds=(0,
   1, 2), engine="cuda"))`` (270 cells), with every launch count set to 0
   just before and read just after, and holds every record bit for bit
   against the reference grid file
   ``src/repro_torch/core/warpsim/data/paper_grid_seeds012.json``. A
   second run of the same study under torch.profiler gives that run's
   wall time, device busy time and idle share.
6. Prints the paper's headline table.
7. Times each family kernel per seed-0 family (warm-up first) by
   torch.profiler's device time, which is the JSON ``ms``, and prints
   CUDA events over back-to-back wrapper calls (launch overhead included)
   as a column of its own, beside the plain version and the bound.
8. Holds K3 (exactly) and K4 (rtol 2e-5 / 2e-2, atol 8 x rtol, float32 /
   bfloat16: the reference's own tolerances) against their plain versions
   at the serve path's shapes (bf16; decode T = 4, t_pad = 8192; prefill
   T = 31, t_pad = 8320; w1/w3 and w2) and at small odd shapes in float32
   and bfloat16.
9. Serves the ``qwen2-moe-a2.7b`` smoke config in float32 with
   ``moe_dispatch="sw_plus"`` on numpy-seeded weights and holds its tokens
   (exactly) and every step's logits (rtol 1e-4, atol 1e-4) against the
   reference's, from ``src/repro_torch/models/data/
   serve_golden_qwen2moe_smoke.json``.
10. Drives the serve path at full width: ``BatchedServer`` on
   ``qwen2-moe-a2.7b`` (24 layers, bf16, SW+ dispatch, random weights
   from seed 0), 8 requests, 4 slots, 16 new tokens each, with the launch
   counts set to 0 just before and read just after: K3 must have run 24
   and K4 72 times per prefill and decode step. Layer 0's K3 and K4
   inputs of one prefill and one decode step are kept and the kernels
   held against their plain versions on them. A second, traced run of the
   same requests gives its wall time, device busy time, idle share and
   top device operations.
11. Times K3 and K4 on those inputs (torch.profiler device time as the
   JSON ``ms``; CUDA events printed apart), beside the plain version, the
   bound and one PyTorch library call computing the same function.

Prints one JSON object of kernel records on the line before the last and
``{"ok": true, "device": ...}`` as the last line. Exits non-zero, printing
no result, without a CUDA device, outside a checkout, or on any mismatch.
"""

import concurrent.futures
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
# The tensor cores' dense bf16 rate (NVIDIA data sheet), which the LM
# kernels' bf16 products are counted against.
PEAK_BF16_OPS_PER_S = 989e12
GRID_FILE = os.path.join(ROOT, "src", "repro_torch", "core", "warpsim",
                         "data", "paper_grid_seeds012.json")
SOURCE = "src/repro_torch/core/warpsim/csrc/warpsim_family.cu"
REPLACES = {"ws_prep_kernel": "src/repro/core/warpsim/_pallas.py:192",
            "ws_family_kernel": "src/repro/core/warpsim/_pallas.py:233",
            "gather_rows_kernel": "src/repro/kernels/coalesced_gather.py:30",
            "gmm_kernel": "src/repro/kernels/moe_gmm.py:24"}
LM_SOURCES = {
    "gather_rows_kernel": "src/repro_torch/kernels/csrc/coalesced_gather.cu",
    "gmm_kernel": "src/repro_torch/kernels/csrc/moe_gmm.cu"}
GOLDEN_FILE = os.path.join(ROOT, "src", "repro_torch", "models", "data",
                           "serve_golden_qwen2moe_smoke.json")
# The reference's own K4 tolerances (tests/test_kernels.py), by dtype name.
GMM_RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = (1e-4, 1e-4)       # rtol, atol: see tests/test_torch_models.py
# The full-width serve: the reference's serve.py defaults, SW+ dispatch.
SERVE = dict(arch="qwen2-moe-a2.7b", requests=8, slots=4, max_new=16,
             max_len=256, seed=0)


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


def bound_ms(byts, ops, peak_ops=PEAK_OPS_PER_S):
    t_bytes = byts / PEAK_BYTES_PER_S
    t_ops = ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def profiled_ms(torch, fn, kernel, reps, attempts=5):
    """Mean device time per launch of `kernel` over `reps` calls of `fn`,
    from torch.profiler, averaged over the device records the trace holds.
    A trace keeps only part of its kernels' device records, the same part
    each time (on an H100: 28 of 40 K3 launches; none of five K4 launches
    of 2.2 ms each), so
    the lost ones seem to lie in the first or last milliseconds of a trace:
    the timed calls are framed by 25 ms of cheap filler launches, and up to
    `attempts` traces are taken; None when none has a record of `kernel`."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device="cuda")

    def filler():
        t_end = time.perf_counter() + 0.025
        while time.perf_counter() < t_end:
            pad.add_(1.0)
            torch.cuda.synchronize()

    for _ in range(attempts):
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle.
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                filler()
                for _ in range(reps):
                    fn()
                filler()
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


# ---------------------------------------------------------------------------
# The LM kernels (K3, K4) and the serve path
# ---------------------------------------------------------------------------


def check_close(torch, name, got, want, rtol, atol, err):
    """Fail unless |got - want| <= atol + rtol |want| everywhere; folds the
    largest difference into err[name]."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} against "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    d = (g - w).abs()
    err[name] = max(err[name], d.max().item() if d.numel() else 0.0)
    if not torch.isfinite(g).all().item():
        fail(f"{name}: non-finite output")
    if (d > atol + rtol * w.abs()).any().item():
        fail(f"{name} differs from its plain version beyond rtol {rtol}, "
             f"atol {atol}: max {d.max().item()}")


def check_exact(torch, name, got, want, err):
    d = (got.float() - want.float()).abs()
    err[name] = max(err[name], d.max().item() if d.numel() else 0.0)
    if not torch.equal(got, want):
        fail(f"{name} differs from its plain version (max {d.max().item()})")


def check_gmm(torch, ref, gmm, x, w, be, bm, err):
    tol = GMM_RTOL[str(x.dtype).replace("torch.", "")]
    check_close(torch, "gmm_kernel", gmm.gmm(x, w, be, bm),
                ref.gmm_ref(x, w, be, bm), tol, 8 * tol, err)


def lm_kernel_checks(torch, dev, cfg, err):
    """K3 exactly and K4 within tolerance against their plain versions, at
    the serve path's shapes for `cfg` (decode: one token per slot; prefill:
    the longest prompt) and at small odd ones."""
    from repro_torch.kernels import coalesced_gather as cg
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as moe_mod
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    d, f, e, k = cfg.d_model, cfg.moe_d_ff, cfg.moe_experts_eff, \
        cfg.moe_top_k
    w1 = randn(e, d, f, scale=d ** -0.5)
    w2 = randn(e, f, d, scale=f ** -0.5)
    for label, t in (("decode", SERVE["slots"]), ("prefill", 31)):
        # k distinct real experts per token, as top-k routing picks them
        idx = torch.stack([torch.randperm(cfg.moe_experts, generator=g,
                                          device=dev)[:k]
                           for _ in range(t)])
        order, dest, be, t_pad = moe_mod.sort_by_expert(idx, e, 128)
        x = randn(t, d)
        row_src, row_valid = ops.row_maps(order // k, dest, t_pad)
        xs = cg.gather_rows(x, row_src, row_valid, t_pad)
        check_exact(torch, "gather_rows_kernel", xs,
                    ref.gather_rows_ref(x, row_src, row_valid, t_pad), err)
        dense = randn(t_pad, d)          # every row filled, same block map
        check_gmm(torch, ref, gmm, xs, w1, be, 128, err)
        check_gmm(torch, ref, gmm, dense, w1, be, 128, err)
        check_gmm(torch, ref, gmm, randn(t_pad, f), w2, be, 128, err)
        print(f"K3 == plain, K4 ~ plain at the {label} shapes: T {t}, t_pad "
              f"{t_pad}, x_sorted ({t_pad}, {d}) bf16, w1/w3 ({e}, {d}, "
              f"{f}), w2 ({e}, {f}, {d}), {int(row_valid.sum())} rows "
              f"filled")
    for dtype in (torch.float32, bf16):
        for m, k, n, e, bm in ((256, 96, 80, 4, 64), (128, 64, 64, 2, 64),
                               (512, 128, 256, 8, 128)):
            be = torch.randint(0, e, (m // bm,), generator=g, device=dev,
                               dtype=torch.int32)
            check_gmm(torch, ref, gmm, randn(m, k, dtype=dtype),
                      randn(e, k, n, dtype=dtype, scale=0.1), be, bm, err)
        for t, d, tp in ((200, 48, 256), (64, 32, 128), (5, 3, 64)):
            x = randn(t, d, dtype=dtype)
            row_src = torch.randint(0, t, (tp,), generator=g, device=dev,
                                    dtype=torch.int32)
            row_valid = (torch.rand((tp,), generator=g, device=dev)
                         < 0.5).to(torch.int32)
            check_exact(torch, "gather_rows_kernel",
                        cg.gather_rows(x, row_src, row_valid, tp),
                        ref.gather_rows_ref(x, row_src, row_valid, tp), err)
    torch.cuda.synchronize()
    print("K3 == plain and K4 ~ plain at small odd shapes (float32, bf16): "
          "gmm (256, 96, 80, 4 experts, bm 64) and two more; gathers with "
          "unfilled rows, rows of 3 elements")


def record_logits(server, log):
    """Wrap `server`'s prefill/decode callables to keep their logits."""
    prefill, decode = server._prefill, server._decode

    def pre(p, b):
        logits, cache = prefill(p, b)
        log.append(("prefill", logits))
        return logits, cache

    def dec(p, t, c):
        logits, cache = decode(p, t, c)
        log.append(("decode", logits))
        return logits, cache

    server._prefill, server._decode = pre, dec


def golden_serve(torch, dev):
    """The smoke serve of the golden file, on the card: tokens exactly and
    every step's logits within LOGIT_TOL of the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import convert
    with open(GOLDEN_FILE, encoding="utf-8") as fh:
        blob = json.load(fh)
    gs = blob["serve"]
    cfg = dataclasses.replace(get_config(gs["arch"], smoke=gs["smoke"]),
                              dtype=gs["dtype"],
                              moe_dispatch=gs["moe_dispatch"])
    params = convert.params_from_numpy(
        convert.numpy_params(cfg, gs["seed"]), cfg, dev)
    reqs = serve.make_requests(cfg, gs["requests"], gs["max_new"],
                               gs["seed"])
    if [r.prompt.tolist() for r in reqs] != blob["prompts"]:
        fail("the smoke serve's prompts differ from the golden file's")
    server = serve.BatchedServer(cfg, params, gs["slots"], gs["max_len"],
                                 device=dev)
    log = []
    record_logits(server, log)
    stats = server.run(reqs)
    tokens = [r.generated for r in reqs]
    if tokens != blob["tokens"]:
        fail(f"smoke serve tokens {tokens} != reference {blob['tokens']}")
    if [k for k, _ in log] != [st["kind"] for st in blob["steps"]]:
        fail("smoke serve ran other steps than the reference")
    worst = 0.0
    v = cfg.vocab_size
    rtol, atol = LOGIT_TOL
    for (_, got), st in zip(log, blob["steps"]):
        want = torch.tensor(st["logits"], dtype=torch.float32)
        got = got.float().cpu()
        d = (got[:, :v] - want).abs()
        worst = max(worst, d.max().item())
        if (d > atol + rtol * want.abs()).any().item() or \
                not bool((got[:, v:] == -1e9).all()):
            fail(f"smoke serve logits differ from the reference's: max "
                 f"{d.max().item()}")
    print(f"reference parity: smoke serve (float32, sw_plus, "
          f"{gs['requests']} requests, {gs['slots']} slots, "
          f"{stats['decode_steps']} decode steps) == golden file: tokens "
          f"exact, logits max |diff| {worst:.3g} (tolerance rtol {rtol}, "
          f"atol {atol})")


class KernelRecorder:
    """Pass-through wrappers around the K3/K4 wrappers that ops.py calls,
    keeping the inputs of layer 0's launches (K3 once, K4 three times) of
    the first prefill and the first decode step, and a running check that
    every step's logits are finite and shaped (slots, vocab)."""

    def __init__(self, torch, server, cg, gmm):
        self.torch, self.cg, self.gmm = torch, cg, gmm
        self.saved = {"prefill": {"gmm": []}, "decode": {"gmm": []}}
        self.kind = None
        self.calls = {"gather": 0, "gmm": 0}
        self.finite = torch.ones((), dtype=torch.bool, device=server.device)
        self.bad_shape = []
        self.orig = (cg.gather_rows, gmm.gmm)
        prefill, decode = server._prefill, server._decode
        vocab, slots = server.cfg.vocab_padded, server.slots

        def wrap(kind, fn, rows):
            def run(*args):
                self.kind = kind
                self.calls = {"gather": 0, "gmm": 0}
                logits, cache = fn(*args)
                self.kind = None
                if tuple(logits.shape) != (rows, vocab):
                    self.bad_shape.append(tuple(logits.shape))
                self.finite &= torch.isfinite(logits).all()
                return logits, cache
            return run

        server._prefill = wrap("prefill", prefill, 1)
        server._decode = wrap("decode", decode, slots)

    def gather_rows(self, x, row_src, row_valid, t_pad):
        rec = self.saved.get(self.kind)
        if rec is not None and self.calls["gather"] == 0 and \
                "gather" not in rec:
            rec["gather"] = (x.clone(), row_src.clone(), row_valid.clone(),
                             t_pad)
        self.calls["gather"] += 1
        return self.orig[0](x, row_src, row_valid, t_pad)

    def gmm_call(self, x, w, be, bm=128):
        rec = self.saved.get(self.kind)
        if rec is not None and self.calls["gmm"] < 3 and len(rec["gmm"]) < 3:
            rec["gmm"].append((x.clone(), w, be.clone(), bm))
        self.calls["gmm"] += 1
        return self.orig[1](x, w, be, bm)

    def __enter__(self):
        self.cg.gather_rows, self.gmm.gmm = self.gather_rows, self.gmm_call
        return self

    def __exit__(self, *exc):
        self.cg.gather_rows, self.gmm.gmm = self.orig
        return False


def full_width_serve(torch, dev, cfg, card, err):
    """The serve path at `cfg`'s full width; returns (layer-0 kernel
    inputs, launches)."""
    from repro_torch import kernels
    from repro_torch.kernels import coalesced_gather as cg
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib

    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"full width: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe_experts} experts padded to "
          f"{cfg.moe_experts_eff} (+{cfg.moe_shared} shared, top "
          f"{cfg.moe_top_k}, d_ff {cfg.moe_d_ff}), vocab {cfg.vocab_size} "
          f"padded to {cfg.vocab_padded}, {cfg.dtype}, moe_dispatch "
          f"{cfg.moe_dispatch}: {n_params / 1e9:.3f} B parameters, "
          f"{n_bytes / 1e9:.3f} GB, drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s")

    server = serve.BatchedServer(cfg, params, SERVE["slots"],
                                 SERVE["max_len"], device=dev)
    reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"],
                               seed=SERVE["seed"])
    rec = KernelRecorder(torch, server, cg, gmm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with rec:
        kernels.reset_launch_counts()
        stats = server.run(reqs)
        launches = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    forwards = stats["requests"] + stats["decode_steps"]   # prefills + steps
    want = {"gather_rows_kernel": cfg.n_layers * forwards,
            "gmm_kernel": 3 * cfg.n_layers * forwards}
    if launches != want:
        fail(f"serve path launches {launches}, expected {want} "
             f"({forwards} forwards of {cfg.n_layers} layers)")
    if rec.bad_shape or not rec.finite.item():
        fail(f"serve path logits not finite or misshaped {rec.bad_shape}")
    for r in reqs:
        if len(r.generated) != SERVE["max_new"] or not all(0 <= t < cfg.vocab_size
                                             for t in r.generated):
            fail(f"request {r.rid} generated {r.generated}")
    print(f"serve path: {stats['requests']} requests "
          f"(prompts {[len(r.prompt) for r in reqs]}), {SERVE['slots']} "
          f"slots, {stats['requests']} prefills + {stats['decode_steps']} "
          f"decode steps, {stats['total_new_tokens']} new tokens; launches "
          f"{launches} == {cfg.n_layers} and {3 * cfg.n_layers} per "
          f"forward")
    print(f"serve path wall {stats['wall_s']:.3f} s, "
          f"{stats['tokens_per_s']:.3f} new tokens/s, peak memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated) [{card}]")

    for kind in ("prefill", "decode"):
        saved = rec.saved[kind]
        if "gather" not in saved or len(saved["gmm"]) != 3:
            fail(f"no layer-0 kernel inputs recorded in a {kind}")
        x, row_src, row_valid, t_pad = saved["gather"]
        check_exact(torch, "gather_rows_kernel",
                    cg.gather_rows(x, row_src, row_valid, t_pad),
                    ref.gather_rows_ref(x, row_src, row_valid, t_pad), err)
        for xg, w, be, bm in saved["gmm"]:
            check_gmm(torch, ref, gmm, xg, w, be, bm, err)
        print(f"  layer 0, {kind} (T {x.shape[0]}, t_pad {t_pad}): K3 == "
              f"plain, K4 ~ plain on the recorded w1, w3, w2 launches")

    # ---- a second run of the same requests, traced ----------------------
    server2 = serve.BatchedServer(cfg, params, SERVE["slots"],
                                  SERVE["max_len"], device=dev)
    reqs2 = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"],
                                seed=SERVE["seed"])
    t_wall, parts = profiled_run(torch, lambda: server2.run(reqs2))
    if [r.generated for r in reqs2] != [r.generated for r in reqs]:
        print("  note: the traced run generated other tokens (scatter-add "
              "order on the card changes from run to run)")
    busy = sum(parts.values())
    if busy <= 0:
        fail("torch.profiler recorded no device time for the serve path")
    print(f"traced second serve run: wall {1e3 * t_wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / (1e3 * t_wall):.4f} "
          f"(both from this run, under torch.profiler) [{card}]")
    for key, ms in sorted(parts.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:10.3f} ms  {key[:70]}")
    del params, server, server2
    return rec.saved, launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def gmm_library(torch, x, w, be, bm, want):
    """One PyTorch call computing K4's function, and how: torch._grouped_mm
    where this PyTorch has it for bf16, else torch.bmm over
    w.index_select(0, block_expert) (the select inside the timed call)."""
    e = w.shape[0]
    offs = (torch.bincount(be.long(), minlength=e) * bm).cumsum(0).to(
        torch.int32)
    tol = GMM_RTOL["bfloat16"]
    candidates = []
    if hasattr(torch, "_grouped_mm"):
        wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
        candidates = [
            ("torch._grouped_mm(x, w, offs)",
             lambda: torch._grouped_mm(x, w, offs=offs)),
            ("torch._grouped_mm(x, w, offs), w column-major (copied once, "
             "outside the timing)",
             lambda: torch._grouped_mm(x, wt, offs=offs))]
    for route, fn in candidates:
        try:
            out = fn()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"  {route}: refused ({str(exc).splitlines()[0][:90]})")
            continue
        d = (out.float() - want.float()).abs()
        if out.shape == want.shape and not (
                d > 8 * tol + tol * want.float().abs()).any().item():
            return fn, route
        print(f"  {route}: disagrees with the plain version (max "
              f"{d.max().item()}); not used")
    nb = x.shape[0] // bm
    bel = be.long()

    def bmm():
        return torch.bmm(x.view(nb, bm, -1), w.index_select(0, bel))
    return bmm, ("torch.bmm over w.index_select(0, block_expert), select "
                 "inside the timing")


def lm_timing(torch, saved, card):
    """Times K3 and K4 on the recorded layer-0 inputs. Returns, per kernel,
    the decode step's (ms, plain_ms, bound_ms, bound_by, library_ms)."""
    from repro_torch.kernels import coalesced_gather as cg
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    k3_cases, k4_cases = [], []        # (label, shape, fn, plain, lib, bound)
    for kind in ("decode", "prefill"):
        x, row_src, row_valid, t_pad = saved[kind]["gather"]
        t, d = x.shape
        item = x.element_size()
        byts = t * d * item + 8 * t_pad + t_pad * d * item
        k3_cases.append((
            f"K3 {kind}", f"({t}, {d}) -> ({t_pad}, {d})",
            lambda x=x, s=row_src, v=row_valid, n=t_pad:
                cg.gather_rows(x, s, v, n),
            lambda x=x, s=row_src, v=row_valid, n=t_pad:
                ref.gather_rows_ref(x, s, v, n),
            lambda x=x, s=row_src: x.index_select(0, s),
            bound_ms(byts, 0)))
        for name, (xg, w, be, bm) in zip(("w1", "w3", "w2"),
                                         saved[kind]["gmm"]):
            m, kk = xg.shape
            e, _, n = w.shape
            distinct = len(set(be.tolist()))
            item = xg.element_size()
            byts = (m * kk * item + distinct * kk * n * item + 4 * be.numel()
                    + m * n * item)
            want = ref.gmm_ref(xg, w, be, bm)
            lib_fn, route = gmm_library(torch, xg, w, be, bm, want)
            del want
            if kind == "decode" and name == "w1":
                print(f"K4 library call: {route}")
            k4_cases.append((
                f"K4 {kind} {name}",
                f"({m}, {kk}) @ ({e}, {kk}, {n}), {distinct} exp",
                lambda xg=xg, w=w, be=be, bm=bm: gmm.gmm(xg, w, be, bm),
                lambda xg=xg, w=w, be=be, bm=bm: ref.gmm_ref(xg, w, be, bm),
                lib_fn,
                bound_ms(byts, 2 * m * kk * n, PEAK_BF16_OPS_PER_S)))

    rows = {}
    print(f"LM kernel times on the serve path's layer-0 inputs, ms per "
          f"launch [{card}]:")
    print(f"  {'launch':18s} {'shape':40s} {'dev':>8s} {'ev':>8s} "
          f"{'plain':>8s} {'bound':>8s} {'by':>5s} {'library':>8s}")
    for kernel, cases, reps in (("gather_rows_kernel", k3_cases, 20),
                                ("gmm_kernel", k4_cases, 10)):
        rows[kernel] = []
        for label, shape, fn, plain_fn, lib_fn, (bnd, by) in cases:
            fn()                                   # warm-up
            torch.cuda.synchronize()
            dev_ms = profiled_ms(torch, fn, kernel, reps)
            if dev_ms is None:
                fail(f"torch.profiler recorded no device time for {label}")
            ev = event_ms(torch, fn, reps)
            plain = event_ms(torch, plain_fn, min(reps, 3))
            lib = event_ms(torch, lib_fn, reps)
            print(f"  {label:18s} {shape:40s} {dev_ms:8.4f} {ev:8.4f} "
                  f"{plain:8.4f} {bnd:8.5f} {by[:5]:>5s} {lib:8.4f}")
            if "decode" in label:
                rows[kernel].append((dev_ms, plain, bnd, by, lib))
    print("  dev: torch.profiler device time (the JSON ms), one trace per "
          "case; ev: CUDA events over back-to-back "
          "wrapper calls, launch overhead included; plain: gather_rows_ref / "
          "gmm_ref (float32) on the card, CUDA events; bound: the larger of "
          "bytes (each input read once, output written once; K4's weights "
          "counted for the distinct experts the block map names) over "
          "3.35 TB/s and bf16 FLOPs over 989 TFLOP/s; library: "
          "x.index_select(0, row_src) for K3, the call above for K4, CUDA "
          "events. The JSON holds the decode step's launches (the most "
          "frequent shape on the path); K4's is the mean of w1, w3, w2.")
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device: nothing to run")
    import repro_torch.core.warpsim as warpsim
    from repro_torch import _nvcc
    from repro_torch import kernels as lm_kernels
    from repro_torch.core.warpsim import _cuda, api, machines
    from repro_torch.core.warpsim.trace import BENCHMARKS
    from repro_torch.kernels import _lib as lm_lib

    # float32 products in full float32 (the parity checks' tolerances
    # assume it; these are PyTorch's defaults for matmul, set explicitly).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- build: one nvcc per source, all started together ---------------
    builds = {"warpsim_family": _cuda.build}
    for name in lm_lib.KERNELS:
        builds[name] = (lambda n=name: lm_lib.build(n))

    def timed(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        built = {name: f.result() for name, f in futs.items()}
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(built)} "
          f"sources in parallel")
    for name, (path, secs) in built.items():
        print(f"  {name}: {secs:.3f} s -> {os.path.relpath(path, ROOT)}")
    for name in lm_lib.KERNELS:
        for line in _nvcc.build_log(built[name][0]).splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  ptxas {line.split('ptxas info')[-1].strip(' :')}")

    suite = list(machines.paper_suite().values())
    err = {k: 0.0 for k in _cuda.KERNELS + lm_kernels.KERNELS}

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

    # ---- the LM kernels and the serve path --------------------------------
    from repro_torch.configs import get_config
    serve_cfg = dataclasses.replace(get_config(SERVE["arch"]),
                                    moe_dispatch="sw_plus")
    lm_kernel_checks(torch, dev, serve_cfg, err)
    golden_serve(torch, dev)
    saved, lm_launches = full_width_serve(torch, dev, serve_cfg, card, err)
    lm_rows = lm_timing(torch, saved, card)
    del saved
    rows.update(lm_rows)
    launches.update(lm_launches)

    kernels = []
    for name in _cuda.KERNELS + lm_kernels.KERNELS:
        r = rows[name]
        n = len(r)
        kernels.append({
            "name": name, "route": "cuda",
            "source": LM_SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name],
            "ms": sum(x[0] for x in r) / n,
            "plain_ms": sum(x[1] for x in r) / n,
            "bound_ms": sum(x[2] for x in r) / n,
            "bound_by": r[0][3],
            "library_ms": (sum(x[4] for x in r) / n if len(r[0]) > 4
                           else None),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
