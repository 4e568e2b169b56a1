#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          (from the root of a checkout)

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel from the ``csrc`` sources in the checkout, one
   ``nvcc`` per source, all started together: the family kernels (K2
   with K1 folded in, and K1's check entry) and the LM kernels (K3
   ``gather_rows_kernel``, K4 ``gmm_kernel``, K5
   ``flash_attention_kernel``, K6 ``ssd_scan_kernel``), and prints
   each one's ``ptxas -v`` report (registers, shared memory, spills);
   beside them, ``cc`` builds the host C cores: the aggregation core
   (``csrc/warpsim_aggregate.c``) and the native engine's scheduling loop
   (``csrc/warpsim_loop.c``).
3. Holds K1's code alone (``ws_prep_kernel``, the check entry) against
   ``prep_ref`` on the same card tensors, and K2 (``ws_family_kernel``,
   which preps the blocks it stages) against ``simulate_family_ref`` run
   on the host CPU, on every one of the warp-size study's 45 trace
   families (the paper grid, seeds 0-2, default sizes): exact equality
   per unit.
4. Holds K2 against ``simulate_family_ref`` once more on the 15 benchmarks
   at 256 threads x the paper suite, three odd geometries (3/5 SMs,
   3/5/7 controllers, 3/5/6-way L1s), the paper's unscaled 16-SM machine
   (whose SW+ unit's state only K2's ``global`` placement holds) and L1s
   of 33-72 ways: exact equality per unit; then the paper suite's
   families once more in each of K2's placements of the state
   (``shared``, ``global``), named. Fails unless each placement launched
   in these checks and the main path.
5. Drives the study's path, ``Session(device="cuda").run(Study(seeds=(0,
   1, 2), engine="cuda"))`` (270 cells), with every launch count set to 0
   just before and read just after (45 ``ws_family_kernel`` launches, one
   a family, and no ``ws_prep_kernel`` launch, ``prep`` or ``prep_ref``
   call), and holds every record bit for bit against the reference grid
   file
   ``src/repro_torch/core/warpsim/data/paper_grid_seeds012.json``.
   Three more runs time the host stages as the program observes them
   into ``warpsim_stage_seconds`` (trace builds, aggregations,
   marshalling, the rest of each launch, the waits for results) and the
   wall; a run under torch.profiler gives its wall,
   device busy time and idle share, beside chip run 8's, and whether the
   wall is below the host stages plus the busy time (host and card
   overlapping: each family's host stages run while the family before
   it is on the card).
6. Prints the paper's headline table.
6a. Runs the dense warp-size sweep (ws4..ws128) and Fig. 1's SIMD sweeps
   (8/16/32 x warp sizes {1,2,4,8} x SIMD width), seed 0, on the card,
   with the launch counts set to 0 just before and read just after (one
   ``ws_family_kernel`` launch a family, 60 in all), and holds their 90
   and 180 records bit for bit against the reference's files
   (``dense_grid_seed0.json``, ``simd_grids_seed0.json``).
6b. Holds K2 against ``simulate_family_ref`` on every family of the dense
   sweep (whose ws4 units have 512 warps, past the 256 K2 keeps in
   registers) and of simd32 (warps of up to 256 threads), in the
   placement the wrapper picks, and prints it and the state's bytes.
6c. Runs the paper grid twice through ``Session(cache_dir=...)`` (a
   directory under ``build/``, removed after): the second run simulates
   nothing and launches nothing, with the first's records; then
   ``Session.cell("BFS", "SW+")`` on a fresh session and the cache's entry
   under ``cell_key`` both equal the grid's record.
6d. The sweep service on the card: starts ``python -m
   repro_torch.core.warpsim.service --port 0 --cache-dir build/<tmp>``
   (default engine and device) and reads its URL from its startup line;
   its ``/healthz`` must say engine ``cuda`` and name the kernel library
   built in step 2. Serves the 270-cell paper study through
   ``Session(backend=ServiceBackend(url))`` cold (each record bit for bit
   against the grid file; the daemon's ``ws_family_kernel`` launches, read
   from ``/healthz`` before and after, must grow by 270: one a simulated
   cell) and warm (0 simulated, 0 launches), printing both walls; sends
   two concurrent ``GET /cell`` for one uncomputed cell (BFS, SW+, seed
   3): simulated +1, dedup_waits +1, launches +1. On a fresh daemon runs
   ``repro_torch.benchmarks.facade_parity``'s grid through
   ``QueueBackend`` (this process drains it on the card), ``ServiceBackend``
   and an in-process ``Session(device="cuda")``: all equal to each other
   and to ``data/facade_grid_seeds01.json``. Between the two, runs the
   daemon's core (``Session.cell``, one one-unit launch a cell) over the
   270 cells in this process on one thread, unprofiled and traced: its
   wall, the card's busy time and K2's share of it. Stops the daemons and
   removes the cache.
7. Times each family kernel per seed-0 family (warm-up first) by
   torch.profiler's device time, which is the JSON ``ms``, and prints
   CUDA events over back-to-back wrapper calls (launch overhead included)
   as a column of its own, beside the plain version and the bound: K2's
   one launch a family, and K1's check entry (off the study's path); for
   K2 also its placement, the longest unit's op count (its steps) and the
   device time per step.
8. Holds K3 (exactly) and K4 (rtol 2e-5 / 2e-2, atol 8 x rtol, float32 /
   bfloat16: the reference's own tolerances) against their plain versions
   at the serve path's shapes (bf16; decode T = 4, t_pad = 8192; prefill
   T = 31, t_pad = 8320; w1/w3 and w2; every row and with the path's
   ``n_rows``) and at small odd shapes in float32 and bfloat16, through
   both of K4's routes (bf16 on the tensor cores; float32, and bf16 at a K
   and N that are not multiples of 8, on the CUDA cores).
9. Serves the ``qwen2-moe-a2.7b`` smoke config in float32 with
   ``moe_dispatch="sw_plus"`` on numpy-seeded weights and holds its tokens
   (exactly) and every step's logits (rtol 1e-4, atol 1e-4) against the
   reference's, from ``src/repro_torch/models/data/
   serve_golden_qwen2moe_smoke.json``.
10. Drives the serve path at full width: ``BatchedServer`` on
   ``qwen2-moe-a2.7b`` (24 layers, bf16, SW+ dispatch, random weights
   from seed 0), 8 requests, 4 slots, 16 new tokens each, with the launch
   counts set to 0 just before and read just after: K3 must have run 24
   and K4 72 times per prefill and decode step, every K4 launch by the
   tensor-core route. Layer 0's K3 and K4 inputs (``n_rows`` included) of
   one prefill and one decode step are kept and the kernels held against
   their plain versions on them. A second, traced run of the
   same requests gives its wall time, device busy time (the device
   records of the trace: kernels, copies and sets), idle share and top
   device records.
11. Times K3 and K4 on those inputs (torch.profiler device time as the
   JSON ``ms``; CUDA events printed apart), beside the plain version, the
   bound (K4's over the rows below ``n_rows``) and one PyTorch library
   call computing the same function (for K4 ``torch._grouped_mm``, with
   its group offsets ending at ``n_rows`` and, printed beside it, at every
   row), timed by torch.profiler device time as the kernels are (CUDA
   events printed apart), and the route each case took; the decode w1
   launch also over every row (what the skip saves) and, cast to float32,
   through K4's CUDA-core route.
12. Holds K5 against ``flash_attention_ref`` in both routes (the
   reference's test shapes, causal and not, float32 at 2e-5 and bf16 at
   3e-2; its four tile sizes; ragged S and hd; the two timing shapes) and
   K6 against
   ``ssd_scan_ref`` and ``ssd_seq_ref`` (rtol 2e-4, atol 2e-5: the
   reference's test shapes, chunks 16-128, P 50 / N 16, four shapes at
   K6's tile edges, the kernel-bench shape).
13. Serves the ``mamba2-780m`` and ``hymba-1.5b`` smoke configs in
   float32 on numpy-seeded weights against the reference's golden files
   (``serve_golden_mamba2_smoke.json``, ``serve_golden_hymba_smoke.json``):
   tokens exactly, logits within rtol 1e-4, atol 1e-4.
14. Builds ``mamba2-780m`` at full width (48 layers, bf16, seed 0), holds
   K6 + D x against the port's ``ssm.ssd_scan`` on layer 0's float32
   pre-scan tensors of a 4096-token prompt (BH 48, P 64, N 128, chunk
   256), then serves it as the reference's ``serve.py`` defaults (8
   requests, 4 slots, 16 new tokens) with the launch counts set to 0 just
   before and read just after: they stay 0, as the reference's ssm model
   path reaches no Pallas kernel. A traced second run gives its idle share
   and top device operations.
15. Drives the kernel-bench path, ``kernel_bench.run()``, with the launch
   counts set to 0 just before and read just after: K5, K4 and K6 must
   each launch. Prints its rows.
16. Times K5 and K6 as in 11, beside their plain versions, bounds and, for
   K5, ``scaled_dot_product_attention``, with K5's route; K6 (three
   launches a call) at the kernel-bench shape and at ``mamba2-780m``'s
   width, with each launch's share.

17. Trains on the card (the training slice; no kernel of the port is on
   this path, as no Pallas kernel is on the reference's: every count
   stays 0). (a) One smoke arch per family (``tinyllama``, ``qwen2-moe``
   with LW+ dispatch, ``mamba2-780m``, ``hymba-1.5b``), float32: three
   train steps from the same numpy-drawn weights on the card and on the
   host CPU, losses and grad norms within rtol 1e-4. (d) K4 through
   ``kernels.ops.moe_gmm`` on card tensors that require grad raises
   ``NotImplementedError`` (no kernel has a backward, as ``pallas_call``
   has none). (b) The reference's kill/resume drill (18 steps, a
   checkpoint every 6, a failure at 12) through ``launch.train`` on
   ``tinyllama-1.1b`` at full width and 2 layers (bf16, ``remat="dots"``,
   checkpoints of 1.6 GB under ``build/``, removed after): the resumed
   losses equal the uninterrupted run's bit for bit. (c) ``python -m
   repro_torch.launch.train --arch tinyllama-1.1b --steps 6 --batch 8
   --seq-len 2048 --accum 2`` in process (22 layers, d_model 2048, bf16,
   ``remat="dots"``, 1.1 B parameters from seed 0), with the launch counts
   set to 0 just before and read just after: finite losses, the median
   step wall of steps 2-5, tokens/s and peak memory; then one step of a
   fresh state of the same run traced: wall, device busy, idle share,
   device time by group (float32 GEMMs, other GEMMs, the rest), the
   step's products' operations (``train_smoke.step_flops``): the bound
   from the attention's causal keys only, the port's padded count beside
   it with the achieved rates, and the top device operations.

18. The distribution layer (``repro_torch.benchmarks.dist_smoke``) on a
   world of one rank (NCCL, a (1, 1) mesh; no kernel of the port is on
   its path: the expert-parallel layer's grouped matmul is the
   reference's plain block-gather product). (a) ``tinyllama-1.1b`` at
   full width (8 x 2048, ``--accum 2``): four steps through
   ``steps.build_step(..., layout="tp")`` against four of the plain step
   from the same seed and batches: losses and grad norms bit for bit,
   and the step wall and peak memory of both, the mesh's within 5 % of
   the plain step's. (c) ``compressed_psum_grads`` over the NCCL group
   on a gradient of (a)'s state: every leaf equal to
   ``dequantize(quantize(g))``. (d) ``elastic.recover`` of a saved state
   (full width, 2 layers, after one mesh step) onto a rebuilt (1, 1)
   mesh: bit for bit. (b) ``qwen2-moe-a2.7b`` at full width: one MoE
   layer in float32 on 2,048 tokens through ``sw_plus_ep_layer``
   against ``dispatch_dense_oracle`` and against ``dispatch_sw_plus``
   on K3 + K4 (rtol 1e-4, atol 1e-5); then three ``swep`` train steps
   at 2 layers, bf16, 4 x 512 tokens: finite losses, step wall, tokens/s
   and peak memory. (e) ``seq_sharded_decode_attention`` at B 8, Sc
   4096, H 16, hd 128 with slots empty, against softmax attention (rtol
   and atol 1e-5). (f) In a child process (``python -m
   repro_torch.benchmarks.dist_smoke --rank0 --device cuda``), rank 0's
   real local step of the dry run's ``tinyllama-1.1b|train_4k|pod16x16``
   cell under ``layout="tp"``: rank 0 of ``launch.dryrun``'s fake group
   of 512 ranks (its collectives move nothing, so values are not
   checked), its own shards of the state on the card from a seed (1/16
   of every layer over "model", FSDP shards gathered a layer at a time),
   its 16 x 4096 tokens; three steps: the median wall of steps 2-3 and
   ``max_memory_allocated``, which must be under 80 GB.

19. The benchmark harness, the dry run and the examples
   (``repro_torch.benchmarks.harness_smoke``). (c) starts first, in a
   child process (a process group of its own): ``python -m
   repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
   --mesh single --force`` (rank 0 of a fake 512-rank group, the step on
   ``meta`` tensors under ``op_analysis``; no card): status ``ok``, its
   row printed, then ``roofline_table.run()``'s rows. Meanwhile (a)
   ``moe_dispatch_bench.run("cuda")`` with the launch counts set to 0
   just before and read just after (K3 once and K4 three times a SW+
   call: 8 and 24), then each router's case on the card and on the host
   CPU from the same inputs: both strategies' outputs against the dense
   oracle (LW+'s with its dropped assignments left out) within K4's
   float32 tolerance, slot efficiencies and drop rates equal to the
   CPU's unless top-k choices flipped at near ties (counted and
   printed); and (b) ``sweep_bench.run(quick=True)`` on the card (one
   ``ws_family_kernel`` launch a trace family cold, none warm, records
   bit for bit with ``engine="torch"`` and the host baselines', the
   reference's quick floors on cold). Then, all at once, child
   processes (d) ``python -m repro_torch.benchmarks.run --only
   moe,roofline`` (exit 0, its CSV rows) and (e) the four examples on the
   card (``quickstart``, ``serve_batched``, ``train_resume`` and
   ``warpsize_study``, the drill's checkpoints and the study's cache
   under ``build/``, removed after): exit codes 0.

20. The service fleet on the card (``fleet_phase``), through the port's
   fleet harnesses; every simulated cell is one one-unit
   ``ws_family_kernel`` launch, checked by the delta of this process's
   count against the daemons' ``simulated`` counters plus a worker's
   cells (the child daemon's by its ``/healthz``), and warm passes
   launch nothing. (a) The SMALL study (BFS, DYN x ws8, SW+ x seeds 0-1,
   128 threads) in process against ``data/facade_grid_seeds01.json``.
   (b) ``chaos_smoke``: a daemon killed mid-study over a shared root, a
   child daemon whose ``WARPSIM_FAULTS`` plan 503s then drops an ack, a
   corrupted worker POST and a drain, the heir's records against the
   same file. (c) ``mesh_smoke``: three daemons
   over disjoint roots at replication 2, cold and warm, the owner killed
   (0 to 2 duplicates), a queue job adopted once. (d) ``obs_smoke``:
   ``/metrics`` over two daemons, one rooted trace, the queue study
   (seeds 2-3) also against ``engine="torch"`` on the host CPU. (e) The
   270-cell paper study on one daemon of this process (a mesh of one,
   cold and warm: the fleets' baseline), then on three: records against
   the grid file,
   270 simulations and 270 launches fleet-wide, the warm re-study
   through another daemon 0 and 0; walls, each daemon's share, peer
   hits and replicas. (f) Its ``/metrics`` on two daemons:
   ``warpsim_cells_simulated_total`` 270 fleet-wide, warm 0.

21. The host engines and the sweep's modes on the card's host
   (``engines_phase``). (a) In this process, which holds a CUDA context:
   the 270-cell paper study (seeds 0-2) through ``Study(engine=e)``:
   ``native`` serially and in a process pool of 4 (``forkserver``
   workers), and ``fast``, ``fast_nested`` and ``event`` in a pool of
   every CPU (their serial walls are ``sweep_bench``'s business, and
   the CPU tests hold them against the reference): every record bit for
   bit against the grid file and step 5's card records, 0
   ``ws_family_kernel`` launches each (the count set to 0 just before,
   read just after), each wall beside the card's. (b)
   ``sweep_bench.run(quick=False, device="cuda")``: the reference's
   ``serial_event``, ``cold_pr1`` and ``cold_pr2`` baselines, ``cold``
   (the card), ``warm``, ``trace_build`` and ``cold_native`` (the host C
   engine's cold study); the reference's floors asserted on ``cold``; its
   rows and the ratios of ``cold`` to each baseline and to
   ``cold_native``, and which of the card's cold study and the host C
   engine's is faster. (c) The host's CPUs, the pool's start method and
   its start cost, traced: the server's start, the workers' launch in
   this process, each worker's age when its first task ran, the results'
   return and the shutdown; then the same pool started from a child
   process whose main program is a ``-c`` string (multiprocessing runs a
   main script again in every worker, a ``-c`` string it does not).

Prints one JSON object of kernel records on the line before the last and
``{"ok": true, "device": ...}`` as the last line. Exits non-zero, printing
no result, without a CUDA device, outside a checkout, or on any mismatch.
"""

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The "FP32" row (outside the tensor cores, NVIDIA data sheet): float32
# kernels held to the reference's float32 tolerances cannot use TF32.
PEAK_FP32_OPS_PER_S = 67e12
STUDY_DATA = os.path.join(ROOT, "src", "repro_torch", "core", "warpsim",
                          "data")
GRID_FILE = os.path.join(STUDY_DATA, "paper_grid_seeds012.json")
# The reference's records of the dense warp-size sweep and of Fig. 1's SIMD
# sweeps, with the studies that made them.
SWEEP_FILES = {"dense": os.path.join(STUDY_DATA, "dense_grid_seed0.json"),
               "simd": os.path.join(STUDY_DATA, "simd_grids_seed0.json")}
# Chip run 8 of the paper study (PR 16), beside which this run's are printed.
RUN8_STUDY = {"wall_s": 0.850, "busy_ms": 179.7, "idle": 0.7576}
SOURCE = "src/repro_torch/core/warpsim/csrc/warpsim_family.cu"
REPLACES = {"ws_prep_kernel": "src/repro/core/warpsim/_pallas.py:192",
            "ws_family_kernel": "src/repro/core/warpsim/_pallas.py:233",
            "gather_rows_kernel": "src/repro/kernels/coalesced_gather.py:30",
            "gmm_kernel": "src/repro/kernels/moe_gmm.py:24",
            "flash_attention_kernel":
                "src/repro/kernels/flash_attention.py:25",
            "ssd_scan_kernel": "src/repro/kernels/ssd_scan.py:30"}
LM_SOURCES = {
    "gather_rows_kernel": "src/repro_torch/kernels/csrc/coalesced_gather.cu",
    "gmm_kernel": "src/repro_torch/kernels/csrc/moe_gmm.cu",
    "flash_attention_kernel":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_scan_kernel": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
DATA_DIR = os.path.join(ROOT, "src", "repro_torch", "models", "data")
GOLDEN_FILE = os.path.join(DATA_DIR, "serve_golden_qwen2moe_smoke.json")
SSM_GOLDEN_FILES = [os.path.join(DATA_DIR, f"serve_golden_{name}_smoke.json")
                    for name in ("mamba2", "hymba")]
# The reference's own K4 tolerances (tests/test_kernels.py), by dtype name.
GMM_RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = (1e-4, 1e-4)       # rtol, atol: see tests/test_torch_models.py
# The full-width serve: the reference's serve.py defaults, SW+ dispatch.
SERVE = dict(arch="qwen2-moe-a2.7b", requests=8, slots=4, max_new=16,
             max_len=256, seed=0)
# The full-width ssm serve: the same defaults.
SSM_SERVE = dict(SERVE, arch="mamba2-780m")
# K5 at the reference's tolerances (tests/test_kernels.py), by dtype name;
# K6 at its rtol / atol.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# K5 in bf16 at S 2048 (rtol, atol): the plain version sums in float32 on
# the bf16 inputs; the kernel sums in float32 too, but rounds each softmax
# weight P to bf16 before the P V product (about 2^-9 relative per weight,
# errors that average out over the 2048 keys), and rounds the output to
# bf16 (at most one ulp, 2^-7 relative). Both stay far inside 4e-3 at
# |o| ~ sqrt(e / S) ~ 0.04. The reference's 3e-2 is about as large as a
# typical output there and would let a dropped KV tile pass.
FLASH_LONG_BF16_TOL = (8e-3, 4e-3)
SSD_TOL = (2e-4, 2e-5)
SSD_PROMPT = 4096          # tokens of the full-width K6 check
# K6 is three launches a call, each named ssd_scan_<stage>: its device time
# per call sums them.
SSD_PROFILE = ("ssd_scan_", 3)
# (BH, S, P, N, q) at K6's tile edges: q and P not multiples of its 64-wide
# tiles, P and N past 64 (two column groups a thread), N and P not
# multiples of 4 (element-wise loads).
SSD_EDGE_SHAPES = ((2, 320, 50, 16, 160), (2, 96, 100, 72, 48),
                   (1, 200, 66, 36, 100), (1, 130, 64, 30, 65))


T_START = time.perf_counter()


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAIL: {msg}")


def stamp(phase: str) -> None:
    """Print the script's elapsed time as `phase` starts."""
    print(f"[{time.perf_counter() - T_START:8.1f} s] {phase}", flush=True)


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
    # K1's check entry: blocks + nbytes in, ctrl + si + ssvc out; a divide
    # and a multiply.
    tables = 8 * (fam.up.numel() + fam.fp.numel())
    return 16 * n + 24 * n + tables, 2 * n


def k2_bytes_ops(fam):
    n_ops = fam.issue.numel()
    n_warps = fam.next0.numel()
    tables = 8 * (fam.up.numel() + fam.fp.numel())
    n_load = int(fam.blk_len[fam.kind == 1].sum())
    n_store = int(fam.blk_len[fam.kind == 2].sum())
    # next0/end per warp; issue/kind/blk_off/blk_len per op; a block's id and
    # its slot (load) or nbytes (store) per block (K1 folded in); cycles + 3
    # counts out per unit. About three double operations per op, four per
    # block, and the occupancy's divide and multiply per store block.
    byts = (tables + 16 * n_warps + 25 * n_ops + 16 * (n_load + n_store)
            + 32 * fam.n_units)
    return byts, 3 * n_ops + 4 * (n_load + n_store) + 2 * n_store


def bound_ms(byts, ops, peak_ops=PEAK_OPS_PER_S):
    t_bytes = byts / PEAK_BYTES_PER_S
    t_ops = ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _on_device(evt) -> bool:
    """A record of work on the card (a kernel, copy or set), not a CPU
    operator (the operators' self device time repeats their kernels') and
    not a program span's range on the card (``obs.stage`` under the
    profiler)."""
    return (str(getattr(evt, "device_type", "")).endswith("CUDA")
            and not getattr(evt, "is_user_annotation", False))


def _filler(torch, pad):
    """25 ms of cheap launches that frame a timed window in a trace."""
    t_end = time.perf_counter() + 0.025
    while time.perf_counter() < t_end:
        pad.add_(1.0)
        torch.cuda.synchronize()


_FILLER_KEYS = []


def filler_keys(torch):
    """Names of the device records the filler makes (traced once)."""
    from torch.profiler import ProfilerActivity, profile
    if not _FILLER_KEYS:
        pad = torch.zeros(1, device="cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _filler(torch, pad)
        _FILLER_KEYS.extend(evt.key for evt in prof.key_averages()
                            if _on_device(evt))
    return set(_FILLER_KEYS)


def profiled_ms(torch, fn, kernel, reps, attempts=5, per_call=1):
    """Mean device time of `kernel` per launch over `reps` calls of `fn`,
    from torch.profiler, averaged over the device records the trace holds
    (`kernel` matches every record whose name holds it; a call that
    launches `per_call` of them counts as one); with `kernel` None, the
    device time of every record but the filler's, per call (a library
    call that launches more than one kernel).
    A trace keeps only part of its kernels' device records, the same part
    each time (on an H100: 28 of 40 K3 launches; none of five K4 launches
    of 2.2 ms each), so
    the lost ones seem to lie in the first or last milliseconds of a trace:
    the timed calls are framed by 25 ms of cheap filler launches, and up to
    `attempts` traces are taken; None when none has a record of `kernel`."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device="cuda")
    skip = filler_keys(torch) if kernel is None else set()

    for _ in range(attempts):
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle.
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _filler(torch, pad)
                for _ in range(reps):
                    fn()
                _filler(torch, pad)
                torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel is None:
                if _on_device(evt) and evt.key not in skip:
                    total += getattr(evt, "self_device_time_total", 0.0)
                    count = reps
            elif kernel in evt.key and _on_device(evt):
                total += getattr(evt, "device_time_total",
                                 getattr(evt, "cuda_time_total", 0.0))
                count += evt.count
        if count > 0 and total > 0.0:
            return total / (count / per_call) / 1e3
    return None


def profiled_split(torch, fn, kernel, reps):
    """Device time per call of `fn` by the name of each kernel whose name
    holds `kernel`, from one torch.profiler trace of `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _filler(torch, pad)
            for _ in range(reps):
                fn()
            _filler(torch, pad)
            torch.cuda.synchronize()
    return {evt.key: evt.self_device_time_total / 1e3 / reps
            for evt in prof.key_averages()
            if kernel in evt.key and _on_device(evt)}


def profiled_run(torch, fn):
    """Run `fn` once under torch.profiler. Returns the run's wall time (s,
    host clock, ending in a synchronize) and its device time (ms) by the
    name of each kernel, copy or set on the card (device records only: a
    CPU operator's self device time repeats its kernels')."""
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
        if t > 0 and _on_device(evt):
            out[evt.key] = out.get(evt.key, 0.0) + t / 1e3
    return wall, out


def check_families(warpsim, fams, err, where=None):
    """Hold K1's check entry against prep_ref (on the card) and K2, which
    preps the blocks itself, against simulate_family_ref (on the host CPU)
    on each ``(units, family)`` of `fams`, exactly, K2 in the placement
    `where` (None: as the wrapper picks it); folds the largest difference
    into `err`. Returns the host-clock ms of the plain versions (prep_ref,
    then simulate_family_ref) per family."""
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
        cycles, counts = _cuda.simulate_family(fam, where=where)
        cpu = _cuda.marshal(units, "cpu")
        t0 = time.perf_counter()
        w_cyc, w_cnt = _cuda.simulate_family(cpu)   # prep_ref, then K2's
        plain_ms[key] = 1e3 * (time.perf_counter() - t0)
        cycles, counts = cycles.cpu(), counts.cpu()
        d = max((cycles - w_cyc).abs().max().item(),
                (counts - w_cnt).abs().max().item())
        err["ws_family_kernel"] = max(err["ws_family_kernel"], d)
        if not (torch.equal(cycles, w_cyc) and torch.equal(counts, w_cnt)):
            fail(f"K2 ({where or _cuda.placement(fam)}) differs from "
                 f"simulate_family_ref on {key} "
                 f"{[c.name for _, c in units]}: {cycles.tolist()} "
                 f"{counts.tolist()} vs {w_cyc.tolist()} {w_cnt.tolist()}")
    return plain_ms


def check_records(records, want, label) -> None:
    """Fail unless `records` equal the grid file's `want` (floats as
    ``float.hex()``) bit for bit, coordinates and order included."""
    if len(records) != len(want):
        fail(f"{label}: {len(records)} records, {len(want)} in the file")
    bad = 0
    for rec, w in zip(records, want):
        got = dataclasses.asdict(rec.result)
        exp = {k: float.fromhex(v) if isinstance(v, str)
               and k not in ("name", "machine") else v
               for k, v in w["result"].items()}
        coords = (rec.machine, rec.bench, rec.seed, rec.n_threads)
        if coords != (w["machine"], w["bench"], w["seed"], w["n_threads"]) \
                or got != exp or not math.isfinite(got["cycles"]):
            bad += 1
            if bad <= 3:
                print(f"  mismatch {coords}: {got} != {exp}")
    if bad:
        fail(f"{bad} of {len(want)} {label} records differ from the "
             f"reference")


#: The study's stages, as the program observes them into
#: ``warpsim_stage_seconds`` (``trace_build`` runs inside ``aggregate``).
STUDY_STAGES = ("trace_build", "aggregate", "marshal", "launch", "wait")


def stage_seconds(obs_mod) -> dict:
    """Seconds the process's default observability domain holds for each
    of :data:`STUDY_STAGES` so far."""
    snap = obs_mod.default().registry.snapshot().get(
        "warpsim_stage_seconds", {})
    return {k: snap.get(f'{{stage="{k}"}}.sum', 0.0) for k in STUDY_STAGES}


def stage_split(before: dict, after: dict, wall: float) -> str:
    """The study's host stages between two :func:`stage_seconds`, in ms
    (aggregation less the trace builds inside it), and the rest."""
    secs = {k: after[k] - before[k] for k in STUDY_STAGES}
    secs["aggregate"] -= secs["trace_build"]
    parts = " ".join(f"{k} {1e3 * v:.3f}" for k, v in secs.items())
    return f"{parts}, other host {1e3 * (wall - sum(secs.values())):.3f} ms"


@contextlib.contextmanager
def counted_calls(module, names):
    """Within the block, count the calls of `module`'s functions `names`
    (the dict it yields, by name)."""
    calls = dict.fromkeys(names, 0)
    saved = {name: getattr(module, name) for name in names}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call
    for name, fn in saved.items():
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def event_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def service_phase(torch, ref, library, card):
    """The sweep service on the card (phase 6d): a port daemon in a
    subprocess computes each cell with one one-unit ``ws_family_kernel``
    launch; its launch counts are read from its ``/healthz``. Fails on
    any check; returns the phase's numbers for the summary line."""
    from repro_torch.benchmarks import facade_parity, service_smoke
    from repro_torch.core.warpsim import _cuda, api
    from repro_torch.core.warpsim import sweep as sweep_mod

    def get(url, path):
        return service_smoke._get(url + path)

    def n_launch(url):
        return service_smoke.launches(url)

    out = {}
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        with service_smoke.boot_daemon(os.path.join(tmp, "a")) as url:
            out["boot_s"] = time.perf_counter() - t0
            health = get(url, "/healthz")
            if health["engine"] != "cuda" or health["device"] != "cuda" \
                    or health["cuda"]["library"] != library \
                    or not health["native"]["loaded"]:
                fail(f"daemon /healthz: engine {health['engine']}, device "
                     f"{health['device']}, cuda {health['cuda']}, native "
                     f"{health['native']}; the library built here is "
                     f"{library}")
            print(f"daemon at {url} (boot {out['boot_s']:.3f} s): engine "
                  f"cuda, library {os.path.relpath(library, ROOT)}")
            study = api.Study(seeds=(0, 1, 2), engine="cuda")
            session = api.Session(backend=api.ServiceBackend(url))
            for run in ("cold", "warm"):
                n0 = n_launch(url)
                sim0 = get(url, "/stats")["counters"]["simulated"]
                t0 = time.perf_counter()
                res = session.run(study)
                out[f"{run}_s"] = time.perf_counter() - t0
                n_run = n_launch(url) - n0
                sim = get(url, "/stats")["counters"]["simulated"] - sim0
                check_records(res.records, ref, f"service {run} study")
                want = 270 if run == "cold" else 0
                if n_run != want or sim != want \
                        or res.stats["simulated"] != want:
                    fail(f"service {run} study: {n_run} ws_family_kernel "
                         f"launches, {sim} simulated (daemon), stats "
                         f"{res.stats}; expected {want}")
                out[f"{run}_launches"] = n_run
                print(f"service {run} study: 270 records == reference grid "
                      f"(bit for bit), {sim} simulated, {n_run} "
                      f"ws_family_kernel launches in the daemon, wall "
                      f"{out[f'{run}_s']:.4f} s [{card}]")
            n0 = n_launch(url)
            delta = service_smoke.dedup_check(
                url, "bench=BFS&machine=SW%2B&seed=3", strict=True)
            n_dedup = n_launch(url) - n0
            if n_dedup != 1:
                fail(f"the concurrent /cell pair launched {n_dedup} times")
            print(f"concurrent cold /cell pair (BFS, SW+, seed 3): simulated "
                  f"+{delta['simulated']}, dedup_waits "
                  f"+{delta['dedup_waits']}, launches +{n_dedup}, served as "
                  f"{delta['served']}")
        # Where the cold study's time goes: the daemon's core, cell by cell
        # (one one-unit launch each), in this process on one thread without
        # HTTP, unprofiled, then traced for the card's busy time.
        cells = sweep_mod.family_major_cells(study.cells())

        def per_cell():
            one = api.Session(device="cuda")
            for _m, cfg, bench, n_threads, seed in cells:
                one.cell(bench, cfg, n_threads=n_threads, seed=seed)

        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        per_cell()
        torch.cuda.synchronize()
        out["per_cell_s"] = time.perf_counter() - t0
        n_cells = _cuda.launch_count("ws_family_kernel")
        t_wall, parts = profiled_run(torch, per_cell)
        busy = sum(parts.values())
        k2 = sum(ms for key, ms in parts.items() if "ws_family_kernel" in key)
        if n_cells != 270:
            fail(f"the per-cell path launched {n_cells} times, not 270")
        out.update(per_cell_busy_ms=busy, per_cell_k2_ms=k2)
        print(f"the daemon's core in this process, cell by cell on one "
              f"thread, no HTTP: wall {out['per_cell_s']:.4f} s "
              f"unprofiled, {n_cells} launches; traced wall "
              f"{1e3 * t_wall:.3f} ms, device busy {busy:.3f} ms (K2 "
              f"{k2:.3f} ms, {k2 / 270:.4f} ms a one-unit launch), idle "
              f"share {1 - busy / (1e3 * t_wall):.4f} [{card}]")
        # The facade grid three ways on a fresh daemon: queue (this process
        # drains it on the card), service, in-process on the card.
        with service_smoke.boot_daemon(os.path.join(tmp, "b")) as url:
            _cuda.reset_launch_counts()
            n0 = n_launch(url)
            runs = facade_parity.run_backends(url, "cuda")
            torch.cuda.synchronize()
            here = _cuda.launch_count("ws_family_kernel")
            there = n_launch(url) - n0
            # 12 one-unit launches as the queue's worker, 4 family launches
            # in process; the daemon adopts the worker's cells and serves
            # the rest from its cache.
            if here != 12 + 4 or there != 0:
                fail(f"facade grid: {here} launches in this process, "
                     f"{there} in the daemon; expected 16 and 0")
            print(f"facade grid (BFS, DYN x ws8, SW+, ws16 x seeds 0-1, 128 "
                  f"threads): queue, service and in-process on the card == "
                  f"each other == facade_grid_seeds01.json; launches: {here} "
                  f"here, {there} in the daemon; walls "
                  + ", ".join(f"{k} {w:.4f} s" for k, (_r, w) in runs.items())
                  + f" [{card}]")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"service phase: {out['phase_s']:.3f} s, daemons stopped, cache "
          f"removed [{card}]")
    return out


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


def check_gmm(torch, ref, gmm, x, w, be, bm, err, n_rows=None):
    """K4 against gmm_ref (with `n_rows`, whose rows past it must be exactly
    zero); returns the route the launch took."""
    tol = GMM_RTOL[str(x.dtype).replace("torch.", "")]
    got = gmm.gmm(x, w, be, bm, n_rows)
    check_close(torch, "gmm_kernel", got, ref.gmm_ref(x, w, be, bm, n_rows),
                tol, 8 * tol, err)
    if n_rows is not None and bool((got[int(n_rows):] != 0).any()):
        fail(f"K4 wrote non-zero rows at or past n_rows {int(n_rows)}")
    return gmm.route(x, w)


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
        n_rows = moe_mod.group_rows(idx, e, 128)
        x = randn(t, d)
        row_src, row_valid = ops.row_maps(order // k, dest, t_pad)
        xs = cg.gather_rows(x, row_src, row_valid, t_pad)
        check_exact(torch, "gather_rows_kernel", xs,
                    ref.gather_rows_ref(x, row_src, row_valid, t_pad), err)
        dense = randn(t_pad, d)          # every row filled, same block map
        routes = set()
        for nr in (None, n_rows):
            routes.add(check_gmm(torch, ref, gmm, xs, w1, be, 128, err, nr))
            routes.add(check_gmm(torch, ref, gmm, dense, w1, be, 128, err,
                                 nr))
            routes.add(check_gmm(torch, ref, gmm, randn(t_pad, f), w2, be,
                                 128, err, nr))
        print(f"K3 == plain, K4 ~ plain at the {label} shapes: T {t}, t_pad "
              f"{t_pad}, x_sorted ({t_pad}, {d}) bf16, w1/w3 ({e}, {d}, "
              f"{f}), w2 ({e}, {f}, {d}), {int(row_valid.sum())} rows "
              f"filled, every row and n_rows {int(n_rows)}; K4 route "
              f"{sorted(routes)}")
    routes = {}
    for dtype in (torch.float32, bf16):
        for m, k, n, e, bm in ((256, 96, 80, 4, 64), (128, 64, 64, 2, 64),
                               (512, 128, 256, 8, 128),
                               (512, 136, 264, 8, 128),
                               (256, 60, 76, 4, 64)):
            be = torch.randint(0, e, (m // bm,), generator=g, device=dev,
                               dtype=torch.int32)
            x, w = randn(m, k, dtype=dtype), randn(e, k, n, dtype=dtype,
                                                   scale=0.1)
            for nr in (None, torch.tensor(bm + bm // 2, dtype=torch.int32,
                                          device=dev)):
                way = check_gmm(torch, ref, gmm, x, w, be, bm, err, nr)
                routes.setdefault(way, set()).add(
                    (m, k, n, str(dtype)[6:]))
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
          "gmm (256, 96, 80, 4 experts, bm 64) and four more, every row and "
          "n_rows mid-block; gathers with unfilled rows, rows of 3 "
          "elements")
    for way, cases in sorted(routes.items()):
        print(f"  K4 route {way}: {sorted(cases)}")


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


def golden_serve(torch, dev, path=GOLDEN_FILE):
    """The smoke serve of the golden file at `path`, on the card: tokens
    exactly and every step's logits within LOGIT_TOL of the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import convert
    with open(path, encoding="utf-8") as fh:
        blob = json.load(fh)
    gs = blob["serve"]
    over = {k: gs[k] for k in ("dtype", "moe_dispatch") if k in gs}
    cfg = dataclasses.replace(get_config(gs["arch"], smoke=gs["smoke"]),
                              **over)
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
    print(f"reference parity: {gs['arch']} smoke serve ({gs['dtype']}, "
          f"{gs.get('moe_dispatch', cfg.family)}, "
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

    def gmm_call(self, x, w, be, bm=128, n_rows=None):
        rec = self.saved.get(self.kind)
        if rec is not None and self.calls["gmm"] < 3 and len(rec["gmm"]) < 3:
            rec["gmm"].append((x.clone(), w, be.clone(), bm,
                               None if n_rows is None else n_rows.clone()))
        self.calls["gmm"] += 1
        return self.orig[1](x, w, be, bm, n_rows)

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
    from repro_torch.kernels import _lib as lm_lib
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
        tc = lm_lib.route_count("gmm_kernel", "tensor_cores")
    peak = torch.cuda.max_memory_allocated(dev)
    forwards = stats["requests"] + stats["decode_steps"]   # prefills + steps
    want = dict({k: 0 for k in kernels.KERNELS},
                gather_rows_kernel=cfg.n_layers * forwards,
                gmm_kernel=3 * cfg.n_layers * forwards)
    if launches != want:
        fail(f"serve path launches {launches}, expected {want} "
             f"({forwards} forwards of {cfg.n_layers} layers)")
    if tc != want["gmm_kernel"]:
        fail(f"{tc} of the serve path's {want['gmm_kernel']} K4 launches "
             f"took the tensor-core route")
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
          f"forward; K4 by the tensor-core route: {tc}")
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
        for xg, w, be, bm, n_rows in saved["gmm"]:
            check_gmm(torch, ref, gmm, xg, w, be, bm, err, n_rows)
        print(f"  layer 0, {kind} (T {x.shape[0]}, t_pad {t_pad}, n_rows "
              f"{int(saved['gmm'][0][4])}): K3 == plain, K4 ~ plain on the "
              f"recorded w1, w3, w2 launches")

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


def gmm_library(torch, x, w, be, bm, n_rows, want):
    """One PyTorch call computing K4's function, and how:
    torch._grouped_mm where this PyTorch has it for bf16, its group offsets
    from the block map, else torch.bmm over w.index_select(0,
    block_expert) (the select inside the timed call). Returns (the call
    over the blocks below n_rows, the blocks K4 computes; the call over
    every block; how), each checked against `want` (gmm_ref over every
    row) on the rows it computes."""
    e = w.shape[0]
    rows = int(n_rows)
    nb = rows // bm
    tol = GMM_RTOL["bfloat16"]

    def offs(blocks):
        return (torch.bincount(blocks.long(), minlength=e) * bm).cumsum(
            0).to(torch.int32)

    def agrees(out, upto):
        d = (out[:upto].float() - want[:upto].float()).abs()
        return out.shape == want.shape and not (
            d > 8 * tol + tol * want[:upto].float().abs()).any().item()

    candidates = []
    if hasattr(torch, "_grouped_mm"):
        wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
        o_skip, o_full = offs(be[:nb]), offs(be)
        candidates = [
            ("torch._grouped_mm(x, w, offs)", w),
            ("torch._grouped_mm(x, w, offs), w column-major (copied once, "
             "outside the timing)", wt)]
    for route, ww in candidates:
        def skip(ww=ww):
            return torch._grouped_mm(x, ww, offs=o_skip)

        def full(ww=ww):
            return torch._grouped_mm(x, ww, offs=o_full)
        try:
            ok = agrees(skip(), rows) and agrees(full(), x.shape[0])
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"  {route}: refused ({str(exc).splitlines()[0][:90]})")
            continue
        if ok:
            return skip, full, route
        print(f"  {route}: disagrees with the plain version; not used")
    bel = be.long()

    def bmm_skip():
        return torch.bmm(x[:rows].view(nb, bm, -1),
                         w.index_select(0, bel[:nb]))

    def bmm_full():
        return torch.bmm(x.view(x.shape[0] // bm, bm, -1),
                         w.index_select(0, bel))
    return bmm_skip, bmm_full, ("torch.bmm over w.index_select(0, "
                                "block_expert), select inside the timing")


def lm_timing(torch, saved, card):
    """Times K3 and K4 on the recorded layer-0 inputs. Returns, per kernel,
    the decode step's (ms, plain_ms, bound_ms, bound_by, library_ms)."""
    from repro_torch.kernels import coalesced_gather as cg
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    # (label, shape, fn, plain, library, library over every row, bound,
    # route, in the JSON)
    k3_cases, k4_cases = [], []
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
            lambda x=x, s=row_src: x.index_select(0, s), None,
            bound_ms(byts, 0), "-", kind == "decode"))
        for name, (xg, w, be, bm, n_rows) in zip(("w1", "w3", "w2"),
                                                 saved[kind]["gmm"]):
            m, kk = xg.shape
            e, _, n = w.shape
            rows = int(n_rows)
            distinct = len(set(be[:rows // bm].tolist()))
            item = xg.element_size()
            # x rows below n_rows and the weights of the experts their
            # blocks name, read once; every output row written once.
            byts = (rows * kk * item + distinct * kk * n * item
                    + 4 * be.numel() + 4 + m * n * item)
            want = ref.gmm_ref(xg, w, be, bm)
            lib_skip, lib_full, how = gmm_library(torch, xg, w, be, bm,
                                                  n_rows, want)
            del want
            if kind == "decode" and name == "w1":
                print(f"K4 library call: {how}")
            k4_cases.append((
                f"K4 {kind} {name}",
                f"({m}, {kk}) @ ({e}, {kk}, {n}), n_rows {rows}, {distinct} "
                f"exp",
                lambda xg=xg, w=w, be=be, bm=bm, r=n_rows:
                    gmm.gmm(xg, w, be, bm, r),
                lambda xg=xg, w=w, be=be, bm=bm, r=n_rows:
                    ref.gmm_ref(xg, w, be, bm, r),
                lib_skip, lib_full,
                bound_ms(byts, 2 * rows * kk * n, PEAK_BF16_OPS_PER_S),
                gmm.route(xg, w), kind == "decode"))

    # The decode w1 launch again over every row (what the skip saves), and
    # K4's CUDA-core route on it in float32; printed, not in the JSON.
    xg, w, be, bm, n_rows = saved["decode"]["gmm"][0]
    m, kk = xg.shape
    e, _, n = w.shape
    item = xg.element_size()
    k4_cases.append((
        "K4 decode w1 all", f"({m}, {kk}) @ ({e}, {kk}, {n}), every row, "
        f"{len(set(be.tolist()))} exp",
        lambda: gmm.gmm(xg, w, be, bm),
        lambda: ref.gmm_ref(xg, w, be, bm), k4_cases[0][5], None,
        bound_ms(item * (m * kk + len(set(be.tolist())) * kk * n + m * n)
                 + 4 * be.numel(), 2 * m * kk * n, PEAK_BF16_OPS_PER_S),
        gmm.route(xg, w), False))
    xf, wf = xg.float(), w.float()
    rows32 = int(n_rows)
    m, kk = xf.shape
    e, _, n = wf.shape
    distinct = len(set(be[:rows32 // bm].tolist()))
    want = ref.gmm_ref(xf, wf, be, bm)
    lib_skip, lib_full, _how = gmm_library(torch, xf, wf, be, bm, n_rows,
                                           want)
    del want
    k4_cases.append((
        "K4 decode w1 fp32", f"({m}, {kk}) @ ({e}, {kk}, {n}), n_rows "
        f"{rows32}, {distinct} exp",
        lambda: gmm.gmm(xf, wf, be, bm, n_rows),
        lambda: ref.gmm_ref(xf, wf, be, bm, n_rows), lib_skip, lib_full,
        bound_ms(4 * (rows32 * kk + distinct * kk * n + m * n)
                 + 4 * be.numel() + 4, 2 * rows32 * kk * n,
                 PEAK_FP32_OPS_PER_S),
        gmm.route(xf, wf), False))

    rows = {}
    print(f"LM kernel times on the serve path's layer-0 inputs, ms per "
          f"launch [{card}]:")
    print(f"  {'launch':18s} {'shape':52s} {'dev':>8s} {'ev':>8s} "
          f"{'plain':>8s} {'bound':>8s} {'by':>5s} {'library':>8s} "
          f"{'lib ev':>8s} {'lib all':>8s}  route")
    for kernel, cases, reps in (("gather_rows_kernel", k3_cases, 20),
                                ("gmm_kernel", k4_cases, 10)):
        rows[kernel] = []
        for label, shape, fn, plain_fn, lib_fn, lib_all_fn, (bnd, by), \
                way, in_json in cases:
            for warm in (fn, plain_fn, lib_fn, lib_all_fn):
                if warm is not None:
                    warm()
            torch.cuda.synchronize()
            dev_ms = profiled_ms(torch, fn, kernel, reps)
            if dev_ms is None:
                fail(f"torch.profiler recorded no device time for {label}")
            ev = event_ms(torch, fn, reps)
            plain = event_ms(torch, plain_fn, min(reps, 3))
            lib = profiled_ms(torch, lib_fn, None, reps)
            lib_ev = event_ms(torch, lib_fn, reps)
            lib_all = (profiled_ms(torch, lib_all_fn, None, reps)
                       if lib_all_fn else None)
            if lib is None or (lib_all_fn and lib_all is None):
                fail(f"torch.profiler recorded no device time for the "
                     f"library call of {label}")
            print(f"  {label:18s} {shape:52s} {dev_ms:8.4f} {ev:8.4f} "
                  f"{plain:8.4f} {bnd:8.5f} {by[:5]:>5s} {lib:8.4f} "
                  f"{lib_ev:8.4f} "
                  f"{'-' if lib_all is None else f'{lib_all:8.4f}':>8s}  "
                  f"{way}")
            if in_json:
                rows[kernel].append((dev_ms, plain, bnd, by, lib))
    print("  dev: torch.profiler device time (the JSON ms), one trace per "
          "case; ev: CUDA events over back-to-back "
          "wrapper calls, launch overhead included; plain: gather_rows_ref / "
          "gmm_ref (float32, with n_rows) on the card, CUDA events; bound: "
          "the larger of bytes (each input read once, output written once; "
          "K4's x rows and FLOPs counted below n_rows, its weights for the "
          "distinct experts the block map names there) over 3.35 TB/s and "
          "bf16 FLOPs over 989 TFLOP/s; library: x.index_select(0, row_src) "
          "for K3, the call above for K4 with its group offsets ending at "
          "n_rows (the blocks K4 computes), torch.profiler device time per "
          "call like dev; lib ev: the same call by CUDA events like ev; lib "
          "all: K4's library call over every row block, device time; "
          "route: K4's route, by dtype, shape and alignment (all: the "
          "decode w1 launch without n_rows, its library the call over "
          "every row; fp32: its inputs cast to float32, its bound over 67 "
          "TFLOP/s). The JSON holds the decode step's bf16 launches (the "
          "most frequent shape on the path); K4's is the mean of w1, w3, "
          "w2, its library_ms the call with offsets ending at n_rows.")
    return rows


# ---------------------------------------------------------------------------
# K5, K6, the ssm serve path and the kernel-bench path
# ---------------------------------------------------------------------------


def check_flash(torch, fa, ref, qkv, causal, err, bq=128, bkv=128,
                tol=None):
    """K5 against flash_attention_ref at `tol` (rtol, atol), FLASH_TOL's
    by default."""
    q, k, v = qkv
    if tol is None:
        tol = (FLASH_TOL[str(q.dtype).replace("torch.", "")],) * 2
    check_close(torch, "flash_attention_kernel",
                fa.flash_attention(q, k, v, causal, bq, bkv),
                ref.flash_attention_ref(q, k, v, causal), *tol, err)


def flash_checks(torch, dev, err):
    """K5 against flash_attention_ref through both routes (float32 on the
    CUDA cores at 2e-5, bf16 on the tensor cores at 3e-2): the reference's
    test shapes, causal and not; its four tile sizes; ragged S and hd; and
    the two timing shapes (causal; bf16 at FLASH_LONG_BF16_TOL). Returns
    the timing cases (label, (q, k, v))."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def qkv(shape, dtype=torch.float32):
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for _ in range(3))

    for dtype in (torch.float32, torch.bfloat16):
        for bh, s, hd, bq, bkv in ((2, 128, 64, 64, 64),
                                   (4, 256, 32, 128, 64),
                                   (1, 512, 128, 128, 128)):
            x = qkv((bh, s, hd), dtype)
            for causal in (True, False):
                check_flash(torch, fa, ref, x, causal, err, bq, bkv)
        x = qkv((2, 256, 64), dtype)
        for bq, bkv in ((64, 64), (128, 64), (64, 128), (256, 256)):
            check_flash(torch, fa, ref, x, True, err, bq, bkv)
        for causal in (True, False):
            check_flash(torch, fa, ref, qkv((3, 100, 40), dtype), causal,
                        err, 100, 100)
    cases = []
    for label, (bh, s, hd, dtype) in (
            ("kernel_bench width", (8, 2048, 64, torch.float32)),
            ("qwen2-moe heads", (16, 2048, 128, torch.bfloat16))):
        x = qkv((bh, s, hd), dtype)
        check_flash(torch, fa, ref, x, True, err,
                    tol=None if dtype == torch.float32
                    else FLASH_LONG_BF16_TOL)
        cases.append((f"K5 {label}", x))
    torch.cuda.synchronize()
    print(f"K5 ~ flash_attention_ref (rtol = atol = 2e-5 float32 on the "
          f"{fa.route(x[0].float())} route, 3e-2 bf16 on the "
          f"{fa.route(x[0].bfloat16())} route): (2, 128, 64), (4, 256, 32), "
          f"(1, 512, 128) causal and not; tiles (64, 64), (128, 64), "
          f"(64, 128), (256, 256); ragged (3, 100, 40); each in both "
          f"dtypes; timing shapes (8, 2048, 64) float32 and (16, 2048, 128) "
          f"bf16 (rtol {FLASH_LONG_BF16_TOL[0]}, atol "
          f"{FLASH_LONG_BF16_TOL[1]}); max |diff| "
          f"{err['flash_attention_kernel']:.3g}")
    return cases


def check_ssd(torch, ssd, ref, args, chunk, err, seq=True):
    """K6 against ssd_scan_ref (and ssd_seq_ref) at SSD_TOL; returns K6's
    output."""
    rtol, atol = SSD_TOL
    got = ssd.ssd_scan_kernel(*args, chunk=chunk)
    check_close(torch, "ssd_scan_kernel", got, ref.ssd_scan_ref(*args, chunk),
                rtol, atol, err)
    if seq:
        check_close(torch, "ssd_scan_kernel", got, ref.ssd_seq_ref(*args),
                    rtol, atol, err)
    return got


def ssd_checks(torch, dev, err):
    """K6 against ssd_scan_ref and ssd_seq_ref (rtol 2e-4, atol 2e-5): the
    reference's test shapes, chunks 16/32/64/128, hymba's P 50 / N 16, and
    the kernel-bench shape. Returns the timing case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def inputs(bh, s, p, n):
        def rn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        return (rn(bh, s, p) * 0.5,
                -torch.nn.functional.softplus(rn(bh, s)),
                rn(bh, s, n) * 0.3, rn(bh, s, n) * 0.3)

    for bh, s, p, n, q in ((2, 64, 16, 8, 16), (3, 128, 32, 16, 32),
                           (1, 256, 64, 32, 64), (2, 64, 50, 16, 16),
                           *SSD_EDGE_SHAPES):
        check_ssd(torch, ssd, ref, inputs(bh, s, p, n), q, err)
    args = inputs(2, 128, 16, 8)
    first = check_ssd(torch, ssd, ref, args, 16, err)
    for q in (32, 64, 128):
        rtol, atol = SSD_TOL
        check_close(torch, "ssd_scan_kernel",
                    check_ssd(torch, ssd, ref, args, q, err), first, rtol,
                    atol, err)
    bench = inputs(16, 4096, 64, 64)
    check_ssd(torch, ssd, ref, bench, 128, err)
    torch.cuda.synchronize()
    print(f"K6 ~ ssd_scan_ref and ssd_seq_ref (rtol {SSD_TOL[0]}, atol "
          f"{SSD_TOL[1]}): (2, 64, 16, 8) q 16, (3, 128, 32, 16) q 32, "
          f"(1, 256, 64, 32) q 64, P 50 / N 16, the tile edges "
          f"{list(SSD_EDGE_SHAPES)} (BH, S, P, N, q), chunks 16/32/64/128 "
          f"agreeing, kernel-bench shape (16, 4096, 64, 64) q 128; max "
          f"|diff| {err['ssd_scan_kernel']:.3g}")
    return [("K6 kernel_bench width", bench, 128)]


def ssd_model_check(torch, dev, cfg, params, err):
    """K6 at `cfg`'s full width: layer 0's pre-scan tensors of a
    SSD_PROMPT-token prompt (the port's ``ssm._project`` and
    ``_causal_conv``, cast to float32) formed as ``ssm.ssd_scan`` forms
    them; ``K6(xdt, da, b, c) + D x`` held against ``ssm.ssd_scan(...)[0]``
    on the same inputs. Returns the timing case."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import common, ssm
    from repro_torch.models import model as model_lib
    lp = model_lib.layer_params(params, 0)
    sp = lp["ssm"]
    g = torch.Generator(device=dev)
    g.manual_seed(SSM_SERVE["seed"])
    s, nh, p, n = SSD_PROMPT, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                           device=dev)
    x = model_lib.embed_inputs(params, cfg, {"tokens": tokens})
    hn = common.rms_norm(x, lp["ssm_norm"], cfg.norm_eps)
    _z, xs, bc, dt, _, _ = ssm._project(sp, hn, cfg)
    xs_c, _ = ssm._causal_conv(xs, sp["conv_x_w"], sp["conv_x_b"])
    bc_c, _ = ssm._causal_conv(bc, sp["conv_bc_w"], sp["conv_bc_b"])
    xm = xs_c.reshape(1, s, nh, p).float()
    bm, cm = (t.reshape(1, s, cfg.ssm_groups, n).float()
              for t in torch.chunk(bc_c, 2, dim=-1))
    dtm = dt.float() + sp["dt_bias"][None, None, :]
    want = ssm.ssd_scan(xm, dtm, sp["A_log"], bm, cm, sp["D"],
                        cfg.ssm_chunk)[0]
    dtf = torch.nn.functional.softplus(dtm)
    da = dtf * (-torch.exp(sp["A_log"]))[None, None, :]

    def heads(t):      # (1, S, nh, W) -> (nh, S, W)
        return t[0].permute(1, 0, 2).contiguous()

    rep = nh // cfg.ssm_groups
    args = (heads(xm * dtf[..., None]), da[0].t().contiguous(),
            heads(bm.repeat_interleave(rep, dim=2)),
            heads(cm.repeat_interleave(rep, dim=2)))
    y = ssd.ssd_scan_kernel(*args, chunk=cfg.ssm_chunk)
    got = y.reshape(1, nh, s, p).permute(0, 2, 1, 3) + \
        xm * sp["D"][None, None, :, None]
    scale = max(1.0, want.abs().max().item())
    worst = (got - want).abs().max().item()
    rtol, atol = SSD_TOL
    check_close(torch, "ssd_scan_kernel", got.contiguous(), want, rtol,
                atol * scale, err)
    print(f"K6 + D x ~ ssm.ssd_scan at {cfg.name}'s width (layer 0, a "
          f"{s}-token prompt, BH {nh}, P {p}, N {n}, chunk "
          f"{cfg.ssm_chunk}, float32): max |diff| {worst:.3g}, max |y| "
          f"{scale:.4g} (rtol {rtol}, atol {atol} x max(1, max |y|))")
    return (f"K6 {cfg.name} width", args, cfg.ssm_chunk)


def full_width_ssm_serve(torch, dev, cfg, params, card):
    """The ssm serve path at `cfg`'s full width, with the launch counts
    set to 0 just before and read just after (all stay 0: the reference's
    ssm model path reaches no Pallas kernel), then a traced second run."""
    from repro_torch import kernels
    from repro_torch.kernels import coalesced_gather as cg
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import serve

    def fresh():
        return (serve.BatchedServer(cfg, params, SSM_SERVE["slots"],
                                    SSM_SERVE["max_len"], device=dev),
                serve.make_requests(cfg, SSM_SERVE["requests"],
                                    SSM_SERVE["max_new"],
                                    seed=SSM_SERVE["seed"]))

    server, reqs = fresh()
    rec = KernelRecorder(torch, server, cg, gmm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with rec:
        kernels.reset_launch_counts()
        stats = server.run(reqs)
        launches = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    if any(launches.values()):
        fail(f"the ssm serve path launched LM kernels: {launches}")
    if rec.bad_shape or not rec.finite.item():
        fail(f"ssm serve logits not finite or misshaped {rec.bad_shape}")
    for r in reqs:
        if len(r.generated) != SSM_SERVE["max_new"] or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"request {r.rid} generated {r.generated}")
    print(f"ssm serve path: {cfg.name}, {stats['requests']} requests "
          f"(prompts {[len(r.prompt) for r in reqs]}), "
          f"{SSM_SERVE['slots']} slots, {stats['requests']} prefills + "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['total_new_tokens']} new tokens; launches {launches}: "
          f"none, as in the reference, whose ssm model path reaches no "
          f"Pallas kernel")
    print(f"ssm serve path wall {stats['wall_s']:.3f} s, "
          f"{stats['tokens_per_s']:.3f} new tokens/s, peak memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated) [{card}]")
    server2, reqs2 = fresh()
    t_wall, parts = profiled_run(torch, lambda: server2.run(reqs2))
    busy = sum(parts.values())
    if busy <= 0:
        fail("torch.profiler recorded no device time for the ssm serve path")
    same = [r.generated for r in reqs2] == [r.generated for r in reqs]
    print(f"traced second ssm serve run: wall {1e3 * t_wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / (1e3 * t_wall):.4f} "
          f"(both from this run, under torch.profiler), same tokens: "
          f"{same} [{card}]")
    for key, ms in sorted(parts.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:10.3f} ms  {key[:70]}")
    return stats


def kernel_bench_path(torch, dev, card, err):
    """``kernel_bench.run()`` on the card with the launch counts set to 0
    just before and read just after: K5, K4 and K6 must each launch. Then
    each kernel of its record rows against its plain version, on the
    record's own inputs."""
    from repro_torch import kernels
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = kernel_bench.run(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    for k in ("flash_attention_kernel", "gmm_kernel", "ssd_scan_kernel"):
        if launches[k] < 1:
            fail(f"the kernel-bench path never launched {k}: {launches}")
    if not all(math.isfinite(us) and us > 0 for _, us, _ in rows):
        fail(f"kernel-bench rows not finite and positive: {rows}")
    print(f"kernel-bench path: {len(rows)} rows in {wall:.3f} s, launches "
          f"{launches} [{card}]")
    rec = kernel_bench.record_inputs(dev)
    check_flash(torch, fa, ref, rec["flash_attention"], True, err)
    check_gmm(torch, ref, gmm, *rec["moe_gmm"], 128, err)
    check_ssd(torch, ssd, ref, rec["ssd_scan"], 128, err)
    torch.cuda.synchronize()
    print("kernel-bench record inputs: K5 (2, 256, 64) float32 causal, K4 "
          "(256, 128) x (4, 128, 128) float32 bm 128, K6 (16, 4096, 64, 64) "
          "q 128, each ~ its plain version at the tolerances above")
    print("  name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"  {name},{us:.1f},{derived:.3f}")
    return launches


def k5_k6_timing(torch, flash_cases, ssd_cases, card):
    """Times K5 and K6 (torch.profiler device time as the JSON ``ms``,
    CUDA events printed apart) beside the plain version, the bound and,
    for K5, scaled_dot_product_attention. Returns the JSON rows from the
    first case of each (the kernel-bench width)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # (kernel, label, shape, fn, plain, lib, bound, reps, route)
    cases = []
    for label, (q, k, v) in flash_cases:
        bh, s, hd = q.shape
        item = q.element_size()
        peak = (PEAK_FP32_OPS_PER_S if q.dtype == torch.float32
                else PEAK_BF16_OPS_PER_S)
        cases.append((
            "flash_attention_kernel", label,
            f"({bh}, {s}, {hd}) {str(q.dtype)[6:]} causal",
            lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, True),
            lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v, True),
            lambda q=q[None], k=k[None], v=v[None]:
                sdpa(q, k, v, is_causal=True),
            bound_ms(4 * bh * s * hd * item,
                     4 * bh * hd * s * (s + 1) // 2, peak), 10,
            fa.route(q)))
    for label, args, chunk in ssd_cases:
        xdt, _, b, _ = args
        bh, s, p = xdt.shape
        n = b.shape[-1]
        byts = 4 * bh * s * (2 * p + 1 + 2 * n)
        # only j <= i of C B^T and of its product with xdt: the kernel
        # forms no more
        ops = (s // chunk) * bh * (chunk * (chunk + 1) * (n + p)
                                   + 4 * chunk * p * n)
        cases.append((
            "ssd_scan_kernel", label, f"({bh}, {s}, {p}, {n}) q {chunk}",
            lambda a=args, c=chunk: ssd.ssd_scan_kernel(*a, chunk=c),
            lambda a=args, c=chunk: ref.ssd_scan_ref(*a, c), None,
            bound_ms(byts, ops, PEAK_FP32_OPS_PER_S), 5, "cuda_cores"))
    rows = {}
    print(f"K5 / K6 times, ms per launch [{card}]:")
    print(f"  {'case':26s} {'shape':34s} {'dev':>8s} {'ev':>8s} "
          f"{'plain':>8s} {'bound':>8s} {'by':>5s} {'library':>8s} "
          f"{'lib ev':>8s}  route")
    for kernel, label, shape, fn, plain_fn, lib_fn, (bnd, by), reps, \
            way in cases:
        for warm in (fn, plain_fn, lib_fn):    # first calls pick and build
            if warm is not None:               # plans (SDPA's backends)
                warm()
        torch.cuda.synchronize()
        key, per_call = (SSD_PROFILE if kernel == "ssd_scan_kernel"
                         else (kernel, 1))
        dev_ms = profiled_ms(torch, fn, key, reps, per_call=per_call)
        if dev_ms is None:
            fail(f"torch.profiler recorded no device time for {label}")
        ev = event_ms(torch, fn, reps)
        plain = event_ms(torch, plain_fn, 3)
        lib = profiled_ms(torch, lib_fn, None, reps) if lib_fn else None
        lib_ev = event_ms(torch, lib_fn, reps) if lib_fn else None
        if lib_fn and lib is None:
            fail(f"torch.profiler recorded no device time for the library "
                 f"call of {label}")
        print(f"  {label:26s} {shape:34s} {dev_ms:8.4f} {ev:8.4f} "
              f"{plain:8.4f} {bnd:8.5f} {by[:5]:>5s} "
              f"{'none' if lib is None else f'{lib:8.4f}':>8s} "
              f"{'none' if lib_ev is None else f'{lib_ev:8.4f}':>8s}  {way}")
        if per_call > 1:
            for name, ms in sorted(profiled_split(torch, fn, key,
                                                  reps).items()):
                print(f"    {name.split('(')[0][:58]:58s} {ms:8.4f} ms")
        if kernel not in rows:
            rows[kernel] = [(dev_ms, plain, bnd, by) +
                            (() if lib is None else (lib,))]
    print("  dev: torch.profiler device time (the JSON ms); ev: CUDA events "
          "over back-to-back wrapper calls, launch overhead included; "
          "plain: flash_attention_ref / ssd_scan_ref on the card, CUDA "
          "events; bound: the larger of bytes (inputs read once, output "
          "written once) over 3.35 TB/s and FLOPs (K5: the causal "
          "4 BH hd S(S+1)/2; K6: S/Q x BH x (Q(Q+1)(N+P) + 4QPN), the "
          "causal half j <= i) over "
          "67 TFLOP/s float32 or 989 TFLOP/s bf16; library: "
          "scaled_dot_product_attention(q, k, v, is_causal=True) on "
          "(1, BH, S, hd) views (a 4-D input lets it pick its fused "
          "kernels), torch.profiler device time per call, lib ev: the same "
          "by CUDA events (K6 has no one-call counterpart); route: K5's by "
          "dtype "
          "(K6 runs on the CUDA cores); below each K6 case, its three "
          "launches (the chunks' states, the pass over chunks, the "
          "outputs) by device time per call. The JSON holds the "
          "first case of each kernel, the kernel-bench width.")
    return rows


def train_phase(torch, dev, card):
    """Step 17: the training path on the card (`repro_torch.benchmarks.
    train_smoke`'s checks; each raises AssertionError on a failure)."""
    from repro_torch import kernels
    from repro_torch.benchmarks import train_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as train_steps

    t_phase = time.perf_counter()
    for arch in train_smoke.SMOKE_ARCHS:
        out = train_smoke.check_smoke_steps(arch, dev)
        print(f"train smoke {arch} (float32, 3 steps, card vs host CPU, "
              f"rtol {train_smoke.SMOKE_RTOL}): losses "
              f"{out['device']['loss']} / {out['cpu']['loss']}, grad norms "
              f"{out['device']['grad_norm']} / {out['cpu']['grad_norm']}")
    train_smoke.check_autograd_guard(dev)
    print("autograd guard: kernels.ops.moe_gmm on a card tensor that "
          "requires grad raised NotImplementedError; under torch.no_grad() "
          "it launched K4")

    stamp("training: the kill/resume drill at full width, 2 layers")
    drill_cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    out = train_smoke.drill(drill_cfg, dev, os.path.join(ROOT, "build"))
    print(f"kill/resume drill ({drill_cfg.name}, {drill_cfg.n_layers} "
          f"layers, full width, {drill_cfg.dtype}, remat "
          f"{drill_cfg.remat}): resumed losses == uninterrupted steps "
          f"12-17 bit for bit: {out['resumed']}; three runs "
          f"{time.perf_counter() - t0:.3f} s [{card}]")

    stamp("training: tinyllama-1.1b at full width")
    cfg = get_config("tinyllama-1.1b")
    kernels.reset_launch_counts()
    res = train_smoke.full_width_run(dev)
    launches = {k: kernels.launch_count(k) for k in kernels.KERNELS}
    if any(launches.values()):
        fail(f"the training path launched LM kernels: {launches}")
    n_params = sum(t.numel() for t in _leaves(
        train_steps.state_struct(cfg)["params"]))
    print(f"full-width training: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads} stored "
          f"as {cfg.n_kv_eff}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}, remat {cfg.remat}, {n_params / 1e9:.3f} B "
          f"parameters; 6 steps of 8 x 2048 tokens (--accum 2); launches "
          f"{launches}")
    print(f"  losses {res['losses']} (finite)")
    print(f"  step walls (s) {[round(x, 4) for x in res['step_s']]}")
    print(f"train step wall, median of steps 2-5: {res['step_wall_s']:.4f} "
          f"s; {res['tokens_per_s']:.1f} tokens/s [{card}]")
    print(f"train peak memory: {res['peak_bytes'] / 1e9:.3f} GB "
          f"(max_memory_allocated) [{card}]")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    step = train_smoke.traced_step(dev)
    t_wall, parts = profiled_run(torch, step)
    busy = sum(parts.values())
    if busy <= 0:
        fail("torch.profiler recorded no device time for the train step")
    print(f"traced train step: wall {1e3 * t_wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / (1e3 * t_wall):.4f} (both "
          f"from this step, under torch.profiler) [{card}]")
    groups = {"float32 GEMMs (attention einsums, TF32 off)": 0.0,
              "other GEMMs (bf16 projections, lm head)": 0.0,
              "elementwise, reductions, copies": 0.0}
    names = list(groups)
    for key, ms in parts.items():
        low = key.lower()
        gemm = any(w in low for w in ("gemm", "nvjet", "cutlass"))
        groups[names[0] if gemm and "f32f32" in low
               else names[1] if gemm else names[2]] += ms
    for name, ms in groups.items():
        print(f"  {name}: {ms:.3f} ms ({ms / busy:.4f} of busy)")
    work = train_smoke.step_flops(cfg, 8, 2048)

    def rate(flops, ms):
        return (f"{flops / ms / 1e9:.1f} TFLOP/s" if ms > 0
                else "not measured (no device record in the group)")

    proj_ms = 1e3 * work["projections"] / PEAK_BF16_OPS_PER_S
    bound = proj_ms + 1e3 * work["attention"] / PEAK_FP32_OPS_PER_S
    padded = proj_ms + 1e3 * work["attention_computed"] / PEAK_FP32_OPS_PER_S
    print(f"  work a step (train_smoke.step_flops): projections and lm head "
          f"{work['projections']:.4e} FLOP (bf16), attention "
          f"{work['attention']:.4e} FLOP (float32, causal keys only); bound "
          f"{bound:.3f} ms at 67 / 989 TFLOP/s; device busy "
          f"{busy / bound:.3f}x the bound")
    print(f"  as the port computes it: attention einsums "
          f"{work['attention_computed']:.4e} FLOP (every KV chunk in full, "
          f"masked keys included), {padded:.3f} ms at the same rates "
          f"(busy {busy / padded:.3f}x); float32 GEMMs "
          f"{rate(work['attention_computed'], groups[names[0]])}, other "
          f"GEMMs {rate(work['projections'], groups[names[1]])}")
    print("  top device records:")
    for key, ms in sorted(parts.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.3f} ms  {key[:70]}")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    print(f"training phase: {time.perf_counter() - t_phase:.3f} s")


def dist_phase(torch, dev, card):
    """Step 18: the distribution layer on the card, a world of one rank
    (NCCL), through ``repro_torch.benchmarks.dist_smoke``'s checks (each
    raises AssertionError on a failure)."""
    from repro_torch import kernels
    from repro_torch.benchmarks import dist_smoke
    from repro_torch.kernels import _lib as lm_lib

    t_phase = time.perf_counter()
    stamp("distribution (a): the full-width step through build_step")
    out = dist_smoke.dense_step_check(dev)
    cfg, args, p, m = out["cfg"], out["args"], out["plain"], out["mesh"]
    print(f"distribution (a): {cfg.name} at full width ({cfg.n_layers} "
          f"layers, {cfg.dtype}, remat {cfg.remat}), {args.batch} x "
          f"{args.seq_len} tokens a step, --accum {args.accum}, "
          f"{dist_smoke.DENSE_STEPS} steps each: build_step(layout='tp') on "
          f"a (1, 1) NCCL mesh against the plain step, same seed and "
          f"batches: losses {m['losses']} == {p['losses']} and grad norms "
          f"{m['grad_norms']} == {p['grad_norms']} bit for bit")
    for name, r in (("plain", p), ("mesh", m)):
        print(f"  {name:5s} step wall (median of steps 1-"
              f"{dist_smoke.DENSE_STEPS - 1}) {r['step_s']:.4f} s, "
              f"{r['tokens_per_s']:.1f} tokens/s, peak "
              f"{r['peak_bytes'] / 1e9:.3f} GB (max_memory_allocated); "
              f"walls {[round(x, 4) for x in r['walls']]} [{card}]")
    print(f"  mesh / plain: wall {m['step_s'] / p['step_s']:.4f}, peak "
          f"{m['peak_bytes'] / p['peak_bytes']:.4f} (limit "
          f"{1 + dist_smoke.SLACK:.2f})")
    c = dist_smoke.compression_check(cfg, args, out["state"],
                                     out["device_mesh"], out["get_batch"])
    print(f"distribution (c): compressed_psum_grads over the NCCL 'data' "
          f"group on a gradient of (a)'s state ({c['leaves']} leaves, "
          f"{c['elements']} {c['dtype']} elements): every leaf == "
          f"dequantize(quantize(g)) bit for bit")
    del out, c
    gc.collect()
    torch.cuda.empty_cache()

    stamp("distribution (d): elastic recovery")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        d = dist_smoke.elastic_check(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"distribution (d): tinyllama-1.1b full width, 2 layers, after "
          f"one mesh step: {d['leaves']} leaves, {d['bytes'] / 1e9:.3f} GB "
          f"saved in {d['save_s']:.3f} s, elastic.recover onto a rebuilt "
          f"(1, 1) mesh in {d['recover_s']:.3f} s: equal bit for bit "
          f"[{card}]")
    gc.collect()
    torch.cuda.empty_cache()

    stamp("distribution (b): qwen2-moe-a2.7b's MoE layer and swep training")
    k3, k4 = (kernels.launch_count(k) for k in ("gather_rows_kernel",
                                                "gmm_kernel"))
    k4_cc = lm_lib.route_count("gmm_kernel", "cuda_cores")
    b = dist_smoke.moe_check(dev)
    k3, k4 = (kernels.launch_count("gather_rows_kernel") - k3,
              kernels.launch_count("gmm_kernel") - k4)
    k4_cc = lm_lib.route_count("gmm_kernel", "cuda_cores") - k4_cc
    if (k3, k4, k4_cc) != (1, 3, 3):
        fail(f"distribution (b): dispatch_sw_plus launched K3 {k3}, K4 {k4} "
             f"({k4_cc} on the CUDA cores), not 1 and 3")
    mc, tc = b["cfg"], b["swep_cfg"]
    print(f"distribution (b): {mc.name} at full width (d_model "
          f"{mc.d_model}, {mc.moe_experts_eff} experts ({mc.moe_experts} "
          f"real), top-{mc.moe_top_k}, moe_d_ff {mc.moe_d_ff}), one MoE "
          f"layer, float32, {math.prod(dist_smoke.MOE_TOKENS)} tokens, "
          f"capacity factor {dist_smoke.MOE_ORACLE_CF}: sw_plus_ep_layer vs "
          f"dispatch_dense_oracle max abs err "
          f"{b['max_abs_err_oracle']:.3e}, vs dispatch_sw_plus on K3 + K4 "
          f"(K3 {k3}, K4 {k4} launches, cuda_cores) "
          f"{b['max_abs_err_sw_plus']:.3e} (rtol "
          f"{dist_smoke.EP_TOL[0]}, atol {dist_smoke.EP_TOL[1]})")
    print(f"  swep training ({tc.n_layers} layers, the only cut; {tc.dtype}, "
          f"remat {tc.remat}, {dist_smoke.SWEP_BATCH} x "
          f"{dist_smoke.SWEP_SEQ} tokens): losses {b['swep_losses']} "
          f"(finite); step wall (median of steps 1-"
          f"{dist_smoke.SWEP_STEPS - 1}) {b['swep_step_s']:.4f} s, "
          f"{b['swep_tokens_per_s']:.1f} tokens/s, peak "
          f"{b['swep_peak_bytes'] / 1e9:.3f} GB; walls "
          f"{[round(x, 4) for x in b['swep_walls']]} [{card}]")
    del b
    gc.collect()
    torch.cuda.empty_cache()

    stamp("distribution (e): sequence-sharded decode")
    e = dist_smoke.decode_check(dev)
    print(f"distribution (e): seq_sharded_decode_attention "
          f"{dist_smoke.DECODE_SHAPE} float32 vs softmax attention: max abs "
          f"err {e['max_abs_err']:.3e} (rtol {dist_smoke.DECODE_TOL[0]}, "
          f"atol {dist_smoke.DECODE_TOL[1]})")
    gc.collect()
    torch.cuda.empty_cache()

    stamp("distribution (f): rank 0's local step of the dry run's cell")
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        f = dist_smoke.rank0_check(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"distribution (f): rank 0 of {f['cell']} on the {f['mesh']} "
          f"mesh of a fake 512-rank group (collectives move nothing; values "
          f"not checked), its shards ({f['state_bytes'] / 1e6:.3f} MB of "
          f"state) and {f['rows']} x {f['seq_len']} tokens on the card: "
          f"step wall (median of steps 2-{dist_smoke.RANK0_STEPS}) "
          f"{f['step_s']:.4f} s, {f['tokens_per_s']:.1f} tokens/s, peak "
          f"{f['peak_bytes'] / 1e9:.3f} GB (max_memory_allocated; limit "
          f"{dist_smoke.CARD_BYTES / 1e9:.0f} GB); walls "
          f"{[round(x, 4) for x in f['walls']]}; child process "
          f"{f['child_s']:.3f} s [{card}]")
    print(f"distribution phase: {time.perf_counter() - t_phase:.3f} s")


def harness_phase(torch, dev, card):
    """Step 19: the benchmark harness, the dry run and the examples, through
    ``repro_torch.benchmarks.harness_smoke`` (each check raises
    AssertionError on a failure)."""
    from repro_torch.benchmarks import harness_smoke as hs
    from repro_torch.benchmarks import roofline_table

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    children = {}
    try:
        stamp("harness (c): the dry run, in a child process")
        children["dryrun"] = hs.start("dryrun", hs.DRYRUN, work)

        stamp("harness (a): moe_dispatch_bench on the card")
        a = hs.moe_check(dev)
        print(f"harness (a): moe_dispatch_bench.run('cuda'): launches "
              f"{a['launches']} (K3 once, K4 three times a SW+ call) "
              f"[{card}]")
        for name, us, derived in a["rows"]:
            print(f"  {name},{us:.1f},{derived:.6g}")
        for label, r in a["routers"].items():
            print(f"  {label}: top-k flips against the host CPU at near "
                  f"ties {r['flips']}; slot efficiencies {r['slot_eff']} "
                  f"(CPU {r['cpu_slot_eff']}), drop rate {r['drop_rate']} "
                  f"(CPU {r['cpu_drop_rate']}); max abs err from the dense "
                  f"oracle {r['max_abs_err']} (rtol {hs.K4_TOL[0]}, atol "
                  f"{hs.K4_TOL[1]})")

        stamp("harness (b): sweep_bench --quick on the card")
        for name, us, derived in hs.sweep_check(dev):
            print(f"  {name},{us:.1f},{derived:.6g}")
        print(f"harness (b): one ws_family_kernel launch a trace family "
              f"cold, none warm, records == engine='torch' and the host "
              f"baselines', quick floors held [{card}]")

        dry = hs.finish(children.pop("dryrun"))
        hs.check_finished("dry run", dry)
        from repro_torch.launch import dryrun
        with open(dryrun.RESULTS, encoding="utf-8") as fh:
            key = "|".join(hs.DRYRUN_CELL[:2]) + "|pod16x16"
            row = json.load(fh)[key]
        if row.get("status") != "ok":
            fail(f"dry run of {key}: {row}")
        r = row["roofline"]
        print(f"harness (c): dry run {key} in {dry['wall_s']:.3f} s (a "
              f"child process; build {row['lower_s']} s, counted call "
              f"{row['compile_s']} s): flops_per_device "
              f"{r['flops_per_device']:.6e}, useful_flops_ratio "
              f"{r['useful_flops_ratio']:.6f}, temp_bytes "
              f"{row['memory']['temp_bytes']:.6e}, collectives "
              f"{r['collective_breakdown']}, dominant {r['dominant']}")
        print(f"  row: {json.dumps(row)}")
        for name, us, derived in roofline_table.run():
            print(f"  {name},{us:.1f},{derived:.6g}")

        stamp("harness (d) and (e): run.py and the examples, child "
              "processes")
        children["run"] = hs.start("run", hs.RUN, work)
        for name, argv in hs.example_commands(work).items():
            children[name] = hs.start(name, argv, work)
        for name in list(children):
            res = hs.finish(children.pop(name))
            hs.check_finished(name, res)
            tail = [ln for ln in res["stdout"].splitlines() if ln.strip()]
            print(f"harness ({'d' if name == 'run' else 'e'}): {name} exit 0 "
                  f"in {res['wall_s']:.3f} s [{card}]; last line: "
                  f"{tail[-1][:160] if tail else ''}")
            if name == "run":
                rows = hs.csv_rows(res["stdout"])
                for row_name, us, derived in rows:
                    print(f"  {row_name},{us:.1f},{derived:.6g}")
    finally:
        for child in children.values():
            child["proc"].kill()
            hs.finish(child)
        shutil.rmtree(work, ignore_errors=True)
    print(f"harness phase: {time.perf_counter() - t_phase:.3f} s")


def _numbers(d) -> dict:
    """A scenario's numbers without its records and mesh blocks."""
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items() if k not in ("records", "mesh")}


def fleet_phase(res, ref, service, card):
    """Step 20: the service fleet on the card, through the port's chaos,
    mesh and obs smokes (their daemons in this process, but the chaos
    smoke's flaky-network daemon, a child). Each smoke checks one
    ``ws_family_kernel`` launch a simulated cell by delta, none warm.
    `res` is the main path's 270-cell study, `ref` the grid file's
    records, `service` phase 6d's numbers."""
    from repro_torch.benchmarks import (
        chaos_smoke, facade_parity, mesh_smoke, obs_smoke,
    )
    from repro_torch.benchmarks import service_smoke as smoke
    from repro_torch.core.warpsim import api
    from repro_torch.core.warpsim.service import SweepClient

    t_phase = time.perf_counter()
    stamp("fleet (a): the SMALL study in process against the facade grid")
    facade = {(w["machine"], w["bench"], w["seed"], w["n_threads"]): w
              for w in facade_parity.reference_records()}

    def grid(study):
        """The facade grid's records of `study`'s cells, in its order."""
        return [facade[(m, bench, seed, n)]
                for m, _cfg, bench, n, seed in study.cells()]

    small = api.Session(device="cuda").run(smoke.small_study(seeds=(0, 1)))
    check_records(small.records, grid(smoke.small_study(seeds=(0, 1))),
                  "SMALL study")
    print(f"SMALL study (BFS, DYN x ws8, SW+ x seeds 0-1, 128 threads): "
          f"{len(small.records)} records == facade_grid_seeds01.json (bit "
          f"for bit)")
    out = {}
    for name, mod in (("chaos", chaos_smoke), ("mesh", mesh_smoke),
                      ("obs", obs_smoke)):
        stamp(f"fleet: {name}_smoke on the card")
        try:
            out[name] = mod.run("cuda", small)
        except smoke.SmokeFailure as e:
            fail(f"{name}_smoke: {e}")
        for scenario, nums in out[name].items():
            print(f"  {name} {scenario}: {_numbers(nums)} [{card}]")
    check_records(out["chaos"]["worker_drain"]["records"],
                  grid(smoke.small_study(benches=("BFS",))),
                  "chaos worker-drain study")
    print("chaos worker-drain study (BFS, computed on the card by the "
          "worker, served by the heir) == facade_grid_seeds01.json (bit "
          "for bit)")
    cpu = api.Session(device="cpu").run(
        smoke.small_study(seeds=(2, 3), engine="torch"))
    check_records(out["obs"]["queue"]["records"],
                  [facade_parity.encode_record(r) for r in cpu.records],
                  "obs queue study")
    print("obs queue study (seeds 2-3, drained by this process on the "
          "card) == engine='torch' on the host CPU (bit for bit)")

    stamp("fleet (e): the 270-cell paper study on one daemon, then three")
    study = api.Study(seeds=(0, 1, 2), engine="cuda")
    # One meshed daemon of this process: the fleets' set-up (threads,
    # client, GIL) without a peer, so no read-through and no replica.
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        with smoke.mesh_fleet(tmp, "solo", 1, "cuda") as (svcs, urls):
            n0 = smoke.kernel_launches()
            t0 = time.perf_counter()
            one = api.Session(device="cuda", backend=api.ServiceBackend(
                client=smoke.fleet_client(urls))).run(study)
            one_cold = time.perf_counter() - t0
            one_launches = smoke.kernel_launches() - n0
            n0 = smoke.kernel_launches()
            t0 = time.perf_counter()
            one_warm = SweepClient(urls[0], timeout=120.0).study(study)
            one_warm_s = time.perf_counter() - t0
            one_counts = (svcs[0].counters["simulated"], one_launches,
                          one_warm.stats["simulated"],
                          smoke.kernel_launches() - n0)
    check_records(one.records, ref, "one in-process daemon's study")
    check_records(one_warm.records, ref, "one in-process daemon's warm study")
    if one_counts != (270, 270, 0, 0):
        fail(f"one in-process daemon: simulated, launches, warm simulated, "
             f"warm launches {one_counts}")
    print(f"one daemon of this process (a mesh of one): 270 records == "
          f"reference grid (bit for bit); cold {one_cold:.4f} s, 270 "
          f"simulated, 270 launches; warm {one_warm_s:.4f} s, 0 simulated, "
          f"0 launches [{card}]")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        try:
            big = mesh_smoke.scenario_cold_then_warm(res, tmp, "cuda",
                                                     study=study)
        except smoke.SmokeFailure as e:
            fail(f"mesh fleet at 270 cells: {e}")
    check_records(big["records"], ref, "fleet cold study")
    if (sum(big["simulated"]), big["cold_launches"],
            big["warm_stats"]["simulated"], big["warm_launches"]) \
            != (270, 270, 0, 0):
        fail(f"fleet study: {_numbers(big)}")
    print(f"fleet of three daemons (disjoint roots, replication "
          f"{mesh_smoke.REPLICATION}): 270 records == reference grid (bit for "
          f"bit); cold {big['cold_s']:.4f} s, 270 simulated fleet-wide "
          f"(by daemon {big['simulated']}), 270 ws_family_kernel launches; "
          f"warm re-study through daemon 2 {big['warm_s']:.4f} s, 0 "
          f"simulated, 0 launches; one daemon cold: in this process "
          f"{one_cold:.4f} s, a child in phase 6d {service['cold_s']:.4f} s "
          f"[{card}]")
    print(f"  serving daemon's study stats: cold {big['cold_stats']}; "
          f"warm {big['warm_stats']}")
    for i, m in enumerate(big["mesh"]):
        print(f"  daemon {i}: simulated {big['simulated'][i]}, "
              + ", ".join(f"{k} {m[k]}" for k in (
                  "peer_forwards", "peer_hits", "peer_fallbacks",
                  "peer_serves", "replicas_sent", "replicas_adopted",
                  "replica_send_failures")))

    stamp("fleet (f): the 270-cell study's metrics on two daemons")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        try:
            with obs_smoke.mesh_duo(tmp, "cuda") as (svcs, urls):
                met = obs_smoke.check_metrics(res, svcs, urls, study, "cuda")
        except smoke.SmokeFailure as e:
            fail(f"obs metrics at 270 cells: {e}")
    check_records(met["records"], ref, "metrics cold study")
    if (sum(met["simulated"]), met["cold_launches"],
            met["warm_launches"]) != (270, 270, 0):
        fail(f"fleet metrics: {_numbers(met)}")
    print(f"two daemons: warpsim_cells_simulated_total {met['simulated']} "
          f"(270 fleet-wide), 270 launches cold in {met['cold_s']:.4f} s; "
          f"warm {met['warm_s']:.4f} s, every monotonic sample forward, 0 "
          f"re-simulations, 0 launches [{card}]")
    print(f"fleet phase: {time.perf_counter() - t_phase:.3f} s [{card}]")


def pool_trace_probe(_arg=None):
    """A pool worker's pid, whether it holds torch, its age in s when the
    task runs (from /proc: the kernel's start time of the process, in
    clock ticks), whether multiprocessing ran the main script in it, and
    the seconds its import of the sweep module took (0 when the pool's
    server had preloaded it)."""
    from multiprocessing import spawn
    with open("/proc/self/stat", encoding="utf-8") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime", encoding="utf-8") as fh:
        uptime = float(fh.read().split()[0])
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    t0 = time.perf_counter()
    import repro_torch.core.warpsim.sweep  # noqa: F401
    return (os.getpid(), "torch" in sys.modules, age,
            sys.modules["__main__"].__name__ == "__mp_main__"
            and bool(spawn.old_main_modules), time.perf_counter() - t0)


def pool_start_split(sweep_mod, workers):
    """One start of the sweep's pool of `workers`, traced, in s: the
    server's ``ensure_running`` (its start when none runs), the workers'
    launch (the first submit starts them all), the probes' return, the
    shutdown; and the probes (:func:`pool_trace_probe`)."""
    import concurrent.futures
    from multiprocessing import forkserver
    ctx = sweep_mod.pool_context()
    t0 = time.perf_counter()
    forkserver.ensure_running()
    t1 = time.perf_counter()
    ex = concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx)
    futs = [ex.submit(pool_trace_probe)]
    t2 = time.perf_counter()
    futs += [ex.submit(pool_trace_probe) for _ in range(workers - 1)]
    probes = [f.result() for f in futs]
    t3 = time.perf_counter()
    ex.shutdown(wait=True)
    t4 = time.perf_counter()
    return t1 - t0, t2 - t1, t3 - t2, t4 - t3, probes


# A pool of 4 started three times from a ``-c`` program, whose workers
# multiprocessing does not run a main script in: the seconds of each.
_POOL_CHILD = """
import concurrent.futures, sys, time
from repro_torch.core.warpsim import sweep
secs = []
for _ in range(3):
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=sweep.pool_context()) as ex:
        list(ex.map(sweep.pool_probe, range(4)))
    secs.append(time.perf_counter() - t0)
print(" ".join(f"{x:.6f}" for x in secs))
"""


def host_load() -> str:
    """The host's load average, this process's threads, its live child
    processes (from /proc) and the CPUs it may run on, as one phrase."""
    import threading
    kids = 0
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat", encoding="utf-8") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        kids += ppid == os.getpid()
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    return (f"load average {load}; {threading.active_count()} threads, "
            f"{kids} child processes; affinity "
            f"{len(os.sched_getaffinity(0))} of {os.cpu_count()} CPUs")


def engines_phase(res, ref, wall, card):
    """Step 21: the host engines and the sweep's modes on the card's host.
    (a) The 270-cell study through the native engine serially and in a
    pool of 4, and through the Python engines in a pool of every CPU, in
    this process (which holds a CUDA context): records bit for bit against the grid file and the step-5
    card records `res`, 0 ``ws_family_kernel`` launches each (the count
    set to 0 just before, read just after), walls beside the card's
    `wall` (step 5's median unprofiled study). (b)
    ``sweep_bench.run(quick=False, device="cuda")``: its rows, the ratios
    of ``cold`` to each baseline and to ``cold_native``; the floors are
    asserted there. (c) The host's CPUs, the pool's start
    method and its start cost, traced, and from a ``-c`` program."""
    from repro_torch.benchmarks import service_smoke, sweep_bench
    from repro_torch.core.warpsim import _cuda, api
    from repro_torch.core.warpsim import sweep as sweep_mod
    from repro_torch.core.warpsim.timing import HOST_ENGINES

    t_phase = time.perf_counter()
    print(f"engines: at the start, {host_load()}")
    # The first pool of this process also starts the pool's server.
    splits = [pool_start_split(sweep_mod, 4) for _ in range(2)]

    stamp("engines (a): the 270-cell study through each host engine")
    card_recs = [dataclasses.asdict(r.result) for r in res.records]
    study = api.Study(seeds=(0, 1, 2))
    out = {}
    ncpu = os.cpu_count() or 1
    runs = [("native", api.InProcessBackend(parallel=False)),
            ("native, pool of 4",
             api.InProcessBackend(parallel=True, max_workers=4))]
    runs += [(f"{e}, pool of {ncpu}",
              api.InProcessBackend(parallel=True, max_workers=ncpu))
             for e in HOST_ENGINES if e != "native"]
    for label, backend in runs:
        engine = label.split(",")[0]
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        got = api.Session(device="cuda", backend=backend).run(
            dataclasses.replace(study, engine=engine))
        secs = time.perf_counter() - t0
        n = _cuda.launch_count("ws_family_kernel")
        check_records(got.records, ref, f"{label} study")
        if [dataclasses.asdict(r.result) for r in got.records] != card_recs:
            fail(f"{label} study: records differ from the card's (step 5)")
        if n or got.stats["family_launches"] or got.stats["simulated"] != 270:
            fail(f"{label} study: {n} ws_family_kernel launches, stats "
                 f"{got.stats}")
        out[label] = secs
        print(f"  {label:18s} 270 records == reference grid and the card's "
              f"(bit for bit), 0 ws_family_kernel launches, wall "
              f"{secs:.6f} s ({secs / wall:.3f}x the card's study, "
              f"{wall:.6f} s) "
              f"[{card}]")

    stamp("engines (b): sweep_bench at the full grid on the card")
    _cuda.reset_launch_counts()
    try:
        rows = sweep_bench.run(quick=False, device="cuda")
    except AssertionError as e:
        fail(f"sweep_bench (full grid): {e}")
    bench_launches = _cuda.launch_count("ws_family_kernel")
    by = {name: (us, d) for name, us, d in rows}
    for name, us, derived in rows:
        print(f"  {name},{us:.1f},{derived:.6g}")
    floors = sweep_bench.effective_floors(False)
    cold = by["sweep/cold"][0]
    print(f"  cold {cold / 1e6:.6f} s; cold_native / cold "
          f"{by['sweep/cold_native'][0] / cold:.6f}; cold_pr1 / cold "
          f"{by['sweep/cold_pr1'][0] / cold:.6f} (floor "
          f"{floors['cold_vs_pr1']}); cold_pr2 / cold "
          f"{by['sweep/cold_pr2'][0] / cold:.6f} (floor "
          f"{floors['cold_vs_pr2']}); serial_event / cold "
          f"{by['sweep/serial_event'][0] / cold:.6f} (floor "
          f"{floors['cold_vs_serial_event']}); floors held; "
          f"{bench_launches} ws_family_kernel launches in the bench "
          f"[{card}]")
    faster = ("the card's cold study" if cold < by["sweep/cold_native"][0]
              else "the host C engine (cold_native)")
    print(f"  faster on this host: {faster}")

    stamp("engines (c): the host and the pool")
    splits.append(pool_start_split(sweep_mod, 4))
    print(f"engines (c): {ncpu} CPUs; {host_load()}; pool start "
          f"method {sweep_mod.POOL_START_METHOD}; in the bench, a pool of "
          f"{int(by['sweep/pool_start'][1])} started, ran a task in each "
          f"worker and shut down in "
          f"{by['sweep/pool_start'][0] / 1e6:.6f} s (min of 3); this "
          f"process's sys.path has {len(sys.path)} entries, the main "
          f"script is {os.path.getsize(__file__)} bytes")
    for label, (server, launch, back, stop, probes) in zip(
            ("first (server's start)", "second", "after the bench"),
            splits):
        ages = sorted(age for _pid, _t, age, _main, _imp in probes)
        print(f"  a pool of 4, {label}: server {server:.6f} s, workers' "
              f"launch here {launch:.6f} s, their tasks' return "
              f"{back:.6f} s, shutdown {stop:.6f} s; workers' age at "
              f"their first task {ages[0]:.2f}-{ages[-1]:.2f} s; "
              f"{len({pid for pid, *_ in probes})} of {len(probes)} "
              f"workers ran a task; main script run again in "
              f"{sum(p[3] for p in probes)}, torch held by "
              f"{sum(p[1] for p in probes)}; the sweep's import in a "
              f"worker {max(p[4] for p in probes):.6f} s at most")
    secs, _ = sweep_bench.pool_start(4)
    print(f"  a pool of 4 mapping sweep.pool_probe (sweep_bench's "
          f"pool_start): {secs:.6f} s")
    src = os.path.join(ROOT, "src")
    try:
        cwd = repr(os.getcwd())
    except OSError as e:
        cwd = f"unreadable ({e})"
    print(f"  this process: {src} on sys.path: {src in sys.path}; working "
          f"directory {cwd}; sys.path {sys.path}")
    child = subprocess.run([sys.executable, "-c", _POOL_CHILD],
                           env=service_smoke.child_env(), capture_output=True,
                           text=True, timeout=300)
    if child.returncode:
        fail(f"pool start from a -c program: {child.stderr[-2000:]}")
    print(f"  a pool of 4 from a -c program (no main script to run again), "
          f"three starts: {child.stdout.strip()} s [{card}]")
    print(f"engines phase: {time.perf_counter() - t_phase:.3f} s [{card}]")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device: nothing to run")
    import repro_torch.core.warpsim as warpsim
    from repro_torch.core.warpsim import runner
    from repro_torch import _nvcc
    from repro_torch import kernels as lm_kernels
    from repro_torch.core.warpsim import _cuda, _native, api, machines
    from repro_torch.core.warpsim import obs as obs_mod
    from repro_torch.core.warpsim import sweep as sweep_mod
    from repro_torch.core.warpsim.trace import BENCHMARKS
    from repro_torch.kernels import _lib as lm_lib

    # The port on PYTHONPATH too, as a user runs it: the process pool's
    # forkserver in CPython 3.12.3 preloads the sweep without the sys.path
    # entry made above (3.12.12 applies it), and without the preload each
    # worker imports the port itself (~1 s on an H100 host).
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p)

    # float32 products in full float32 (the parity checks' tolerances
    # assume it; these are PyTorch's defaults for matmul, set explicitly).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- build: one compiler per source, all started together -----------
    # (nvcc for the kernels; cc for the host C cores: the aggregation core
    # and the native engine's scheduling loop)
    builds = {"warpsim_family": _cuda.build,
              "warpsim_aggregate": _native.build,
              "warpsim_loop": _native.build_loop}
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
    for name in builds:
        if name in ("warpsim_aggregate", "warpsim_loop"):
            continue
        for line in _nvcc.build_log(built[name][0]).splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  ptxas {line.split('ptxas info')[-1].strip(' :')}")

    suite = list(machines.paper_suite().values())
    err = {k: 0.0 for k in _cuda.KERNELS + lm_kernels.KERNELS}

    # ---- K1 and K2 against their plain versions on the main path's
    stamp("K1 and K2 on the main path's 45 families")
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

    # ---- K2 at 256 threads and on other geometries -----------------------
    stamp("K2 at 256 threads, odd, 16-SM and wide-way geometries")
    odd = [machines.baseline(16, num_sms=3, num_mem_ctrls=5, l1_ways=3,
                             l1_size_bytes=64 * 3 * 7),
           machines.sw_plus(num_sms=5, num_mem_ctrls=3, l1_ways=5,
                            l1_size_bytes=64 * 5 * 11),
           machines.lw_plus(num_sms=3, num_mem_ctrls=7, l1_ways=6,
                            l1_size_bytes=64 * 6 * 13)]
    sixteen = [machines.baseline(32, num_sms=16), machines.sw_plus(num_sms=16)]
    wide = [machines.baseline(8, l1_ways=40, l1_size_bytes=64 * 40 * 3),
            machines.sw_plus(l1_ways=72, l1_size_bytes=64 * 72 * 2),
            machines.lw_plus(l1_ways=33, l1_size_bytes=64 * 33 * 5)]
    small = {}
    for i, cfgs in enumerate((suite, odd, sixteen, wide)):
        for bench in BENCHMARKS:
            units = family_units(warpsim, bench, 256, 0, cfgs)
            small[(bench, 256, i)] = (units, _cuda.marshal(units, dev))
    check_families(warpsim, small, err)
    print(f"K1, K2 == plain versions on "
          f"{sum(f.n_units for _, f in small.values())} more units: "
          f"15 benches at 256 threads x (paper suite, 3 odd geometries, "
          f"16 SMs (ws32, SW+), L1s of 40/72/33 ways)")
    # Each placement the paper suite's families fit, named, so that every
    # placement is held against the plain version whatever the sizes pick.
    suite_fams = {k: v for k, v in small.items() if k[2] == 0}
    for where in _cuda.PLACEMENTS:
        check_families(warpsim, suite_fams, err, where)
    print(f"K2 == plain version in each placement {_cuda.PLACEMENTS} on the "
          f"15 benches at 256 threads x the paper suite")
    del small, suite_fams
    placed = {r: _cuda.route_count("ws_family_kernel", r)
              for r in _cuda.PLACEMENTS}

    # ---- the main path ---------------------------------------------------
    stamp("the study's main path")
    with open(GRID_FILE, encoding="utf-8") as fh:
        ref = json.load(fh)["records"]
    study = api.Study(seeds=(0, 1, 2), engine="cuda")
    with counted_calls(_cuda, ("prep", "prep_ref")) as prep_calls:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = api.Session(device=dev).run(study)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _cuda.launch_count(k) for k in _cuda.KERNELS}
    check_records(res.records, ref, "paper grid")
    if res.stats["family_launches"] != 45:
        fail(f"family_launches {res.stats['family_launches']} != 45")
    # One kernel a family: K2 preps the blocks itself, so the path launches
    # no K1 and allocates no prepped columns.
    if launches != {"ws_prep_kernel": 0, "ws_family_kernel": 45} \
            or any(prep_calls.values()):
        fail(f"the main path is not one ws_family_kernel launch a family: "
             f"launches {launches}, calls {prep_calls}")
    path_placed = {r: _cuda.route_count("ws_family_kernel", r)
                   for r in _cuda.PLACEMENTS}
    if min(placed[r] + path_placed[r] for r in _cuda.PLACEMENTS) <= 0:
        fail(f"a placement of K2's state never launched: checks {placed}, "
             f"main path {path_placed}")
    print(f"main path: 270 records == reference grid (bit for bit); "
          f"stats {res.stats}; launches {launches}; calls {prep_calls}; K2 "
          f"placements {path_placed} (checks before it: {placed})")
    print(f"main path wall: {wall:.3f} s for 270 cells "
          f"(host stages + 45 family launches) [{card}]")

    # ---- the host stages, by host clock; then a run traced ----------------
    stamp("the study's host stages, wall and idle share")
    walls = []
    for i in range(3):
        before = stage_seconds(obs_mod)
        t0 = time.perf_counter()
        api.Session(device=dev).run(study)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"  unprofiled run {i + 1}: wall {1e3 * walls[-1]:.3f} ms: "
              f"{stage_split(before, stage_seconds(obs_mod), walls[-1])} "
              f"[{card}]")
    print(f"study wall, unprofiled, median of 3: "
          f"{statistics.median(walls):.4f} s (run 8: "
          f"{RUN8_STUDY['wall_s']} s) [{card}]")
    before = stage_seconds(obs_mod)
    t_wall, parts = profiled_run(
        torch, lambda: api.Session(device=dev).run(study))
    after = stage_seconds(obs_mod)
    busy = sum(parts.values())
    host = sum(after[k] - before[k]
               for k in ("aggregate", "marshal", "launch"))
    print(f"traced run: wall {1e3 * t_wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / (1e3 * t_wall):.4f} (run 8: "
          f"{RUN8_STUDY['busy_ms']} ms, {RUN8_STUDY['idle']}; all from this "
          f"run, under torch.profiler) [{card}]")
    print(f"  host stages: {stage_split(before, after, t_wall)}")
    print(f"  overlap: wall {1e3 * t_wall:.3f} ms "
          f"{'<' if 1e3 * t_wall < 1e3 * host + busy else '>='} host stages "
          f"{1e3 * host:.3f} + device busy {busy:.3f} = "
          f"{1e3 * host + busy:.3f} ms; device busy a family "
          f"{busy / 45:.3f} ms against the host stages' "
          f"{1e3 * host / 45:.3f} ms")
    for key, ms in sorted(parts.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:10.3f} ms  {key[:70]}")

    # ---- headline table --------------------------------------------------
    print("headline (mean [min, max] over seeds 0-2):")
    for metric, band in res.bands().items():
        print(f"  {metric:40s} {band['mean']:.6f} "
              f"[{band['min']:.6f}, {band['max']:.6f}]")

    # ---- the dense and SIMD warp-size sweeps -------------------------------
    stamp("the dense and SIMD warp-size sweeps")
    sweep_studies = {}
    for name, path in SWEEP_FILES.items():
        with open(path, encoding="utf-8") as fh:
            blob = json.load(fh)
        studies = [api.Study.from_dict(dict(d, engine="cuda"))
                   for d in blob["studies"]]
        sweep_studies[name] = studies
        session = api.Session(device=dev)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        runs = [session.run(st) for st in studies]
        torch.cuda.synchronize()
        s_wall = time.perf_counter() - t0
        n_launch = {k: _cuda.launch_count(k) for k in _cuda.KERNELS}
        n_fam = sum(r.stats["trace_families"] for r in runs)
        if n_launch != {"ws_prep_kernel": 0, "ws_family_kernel": n_fam} \
                or any(r.stats["family_launches"] != 15 for r in runs):
            fail(f"{name} sweep: launches {n_launch} for {n_fam} families, "
                 f"stats {[r.stats for r in runs]}")
        check_records([rec for r in runs for rec in r.records],
                      blob["records"], f"{name} sweep")
        print(f"{name} sweep: {sum(len(r) for r in runs)} records == "
              f"reference (bit for bit), {n_fam} families, launches "
              f"{n_launch}, wall {s_wall:.3f} s [{card}]")
        for r in runs:
            for m in r.machines:
                print(f"  {m:12s} geomean IPC "
                      f"{runner.mean_ipc(r.per_bench(m)):.6f}")

    # ---- K2 on the sweeps' widest shapes ------------------------------------
    stamp("K2 on every ws4 and simd32 family")
    wide_fams = {}
    dense_cfgs = list(sweep_studies["dense"][0].machine_set().values())
    simd32_cfgs = list(sweep_studies["simd"][2].machine_set().values())
    for tag, cfgs in (("ws4", dense_cfgs), ("simd32", simd32_cfgs)):
        for bench in BENCHMARKS:
            units = family_units(warpsim, bench, None, 0, cfgs)
            wide_fams[(bench, tag)] = (units, _cuda.marshal(units, dev))
    check_families(warpsim, wide_fams, err)
    torch.cuda.synchronize()
    print(f"K1, K2 == plain versions on the {len(wide_fams)} families of the "
          f"dense sweep (ws4..ws128; ws4: 512 warps a unit) and of simd32 "
          f"(ws32..ws256), K2 in the placement the wrapper picks:")
    for (bench, tag), (units, fam) in wide_fams.items():
        widest = max(st.n_warps for st, _cfg in units)
        print(f"  {tag:6s} {bench:5s} warps {widest:4d} placement "
              f"{_cuda.placement(fam):6s} state {fam.state_bytes} bytes")
    del wide_fams

    # ---- a warm cache ----------------------------------------------------
    stamp("warm cache and Session.cell")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cold = api.Session(device=dev, cache_dir=tmp).run(study)
        check_records(cold.records, ref, "cold cached run")
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        warm = api.Session(device=dev, cache_dir=tmp).run(study)
        warm_wall = time.perf_counter() - t0
        n_warm = _cuda.launch_count("ws_family_kernel")
        if warm.stats["simulated"] or warm.stats["family_launches"] \
                or n_warm or warm.stats["cache_hits"] != 270:
            fail(f"the warm run simulated: stats {warm.stats}, "
                 f"{n_warm} launches")
        check_records(warm.records, ref, "warm cached run")
        cfg = machines.sw_plus()
        grid_rec = dataclasses.asdict(
            res.by(machine="SW+", bench="BFS", seed=0).one())
        cell = api.Session(device=dev).cell("BFS", "SW+")
        read = sweep_mod.ResultCache(tmp).get(
            sweep_mod.cell_key("BFS", cfg, None, 0))
        if dataclasses.asdict(cell) != grid_rec or read is None \
                or dataclasses.asdict(read) != grid_rec:
            fail(f"Session.cell or the cache's cell differs from the grid's "
                 f"record: {cell} / {read} / {grid_rec}")
    print(f"warm cache: cold run {cold.stats['simulated']} simulated, "
          f"{cold.stats['family_launches']} launches; warm run "
          f"{warm.stats['cache_hits']} hits, 0 simulated, {n_warm} launches, "
          f"{1e3 * warm_wall:.3f} ms; records == the grid's; "
          f"Session.cell('BFS', 'SW+') and the cache's cell_key entry == the "
          f"grid's record [{card}]")

    # ---- the sweep service on the card -----------------------------------
    stamp("the sweep service on the card")
    service = service_phase(torch, ref, built["warpsim_family"][0], card)

    # ---- timing per family (seed 0) ---------------------------------------
    stamp("K1/K2 timing per family")
    rows = {k: [] for k in _cuda.KERNELS}
    print(f"per-family times, ms per launch; K2 is the study's one launch "
          f"a family, K1 its check entry, off the path [{card}]:")
    print(f"  {'bench':5s} {'units':>5s} {'warps':>6s} {'ops':>7s} "
          f"{'blocks':>7s} | {'K1 dev':>8s} {'K1 ev':>8s} {'plain':>8s} "
          f"{'bound':>8s} | {'K2 dev':>8s} {'K2 ev':>8s} {'plain':>8s} "
          f"{'bound':>8s} {'place':>6s} {'steps':>6s} {'ns/step':>8s}")
    for bench in BENCHMARKS:
        units, fam = fams[(bench, 0)]
        steps = max(len(st.issue) for st, _cfg in units)
        _cuda.prep(fam)                           # warm-up
        _cuda.simulate_family(fam)
        torch.cuda.synchronize()

        def k1():
            _cuda.prep(fam)

        def k1_plain():
            _cuda.prep_ref(fam.up, fam.fp, fam.blocks, fam.nbytes)

        def k2():
            _cuda.simulate_family(fam)

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
              f"{plain_ms[(bench, 0)]:8.1f} {b2:8.6f} "
              f"{_cuda.placement(fam):>6s} {steps:6d} "
              f"{1e6 * (k2_dev or math.nan) / steps:8.1f}")
    print("  dev: device time per launch from torch.profiler (nan: no "
          "device record in 5 traces; that family is left out of the JSON "
          "means); ev: CUDA events over back-to-back wrapper calls (20 for "
          "K1, 3 for K2), launch overhead included, not used in the JSON; "
          "K1 plain: prep_ref on the card, CUDA events; K2 plain: "
          "prep_ref then simulate_family_ref on the host CPU, host clock; "
          "bound: bytes read once and written once over 3.35 TB/s; place: "
          "K2's "
          "placement of the state; steps: ops of the family's longest unit "
          "(one scheduling step each); ns/step: K2 dev over steps")
    for name, r in rows.items():
        if not r:
            fail(f"torch.profiler recorded no device time for {name}")
        print(f"  {name}: JSON means over the {len(r)} of 15 families with "
              f"a device record")

    # ---- the LM kernels and the serve path --------------------------------
    stamp("K3/K4 checks and the qwen2-moe smoke serve")
    from repro_torch.configs import get_config
    serve_cfg = dataclasses.replace(get_config(SERVE["arch"]),
                                    moe_dispatch="sw_plus")
    lm_kernel_checks(torch, dev, serve_cfg, err)
    golden_serve(torch, dev)
    stamp("full-width qwen2-moe serve")
    saved, lm_launches = full_width_serve(torch, dev, serve_cfg, card, err)
    stamp("K3/K4 timing")
    lm_rows = lm_timing(torch, saved, card)
    del saved
    # Servers hold themselves in closures: collect them, so the qwen2-moe
    # weights leave the card before the ssm phases measure peak memory.
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(lm_rows)
    launches.update(lm_launches)

    # ---- K5, K6, the ssm family and the kernel-bench path ----------------
    from repro_torch.models import model as model_lib
    stamp("K5 and K6 checks")
    flash_cases = flash_checks(torch, dev, err)
    ssd_cases = ssd_checks(torch, dev, err)
    stamp("ssm and hybrid smoke serves")
    for path in SSM_GOLDEN_FILES:
        golden_serve(torch, dev, path)
    stamp("full-width mamba2-780m: K6 check and serve")
    ssm_cfg = get_config(SSM_SERVE["arch"])
    t0 = time.perf_counter()
    params = model_lib.init_params(ssm_cfg, seed=SSM_SERVE["seed"],
                                   device=dev)
    torch.cuda.synchronize()
    print(f"full width: {ssm_cfg.name}, {ssm_cfg.n_layers} layers, d_model "
          f"{ssm_cfg.d_model}, {ssm_cfg.ssm_heads} SSD heads of "
          f"{ssm_cfg.ssm_headdim}, state {ssm_cfg.ssm_state}, chunk "
          f"{ssm_cfg.ssm_chunk}, vocab {ssm_cfg.vocab_size} padded to "
          f"{ssm_cfg.vocab_padded}, {ssm_cfg.dtype}: "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"parameters, "
          f"{sum(t.nbytes for t in _leaves(params)) / 1e9:.3f} GB, drawn "
          f"on the card in {time.perf_counter() - t0:.3f} s")
    ssd_cases.append(ssd_model_check(torch, dev, ssm_cfg, params, err))
    full_width_ssm_serve(torch, dev, ssm_cfg, params, card)
    del params
    stamp("kernel-bench path")
    kb_launches = kernel_bench_path(torch, dev, card, err)
    stamp("K5/K6 timing")
    rows.update(k5_k6_timing(torch, flash_cases, ssd_cases, card))
    stamp("training: smoke steps against the host CPU, the autograd guard")
    train_phase(torch, dev, card)
    dist_phase(torch, dev, card)
    harness_phase(torch, dev, card)
    stamp("the service fleet on the card")
    fleet_phase(res, ref, service, card)
    stamp("the host engines and the sweep's modes on the card's host")
    engines_phase(res, ref, statistics.median(walls), card)
    stamp("done")
    del flash_cases, ssd_cases
    for name in ("flash_attention_kernel", "ssd_scan_kernel"):
        launches[name] = kb_launches[name]

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
