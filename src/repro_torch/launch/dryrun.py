"""Multi-pod dry run: build and count every (arch x shape x mesh) cell.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's jitted step on 256 or 512 forced host devices. The port
builds each cell's step with ``steps.build_step`` on the reference's
production mesh (16x16, or 2x16x16: ``mesh.make_production_mesh``) in
one process, as rank 0 of a fake process group of 512 ranks
(``torch.testing``'s ``FakeStore`` and its ``"fake"`` backend: every
collective returns at once, moving nothing), and calls it once on
``meta`` tensors (shapes and dtypes, no memory, no arithmetic) under
``roofline.op_analysis``. Nothing touches a card, so it runs on any host.
The process group is the process's default group, so a caller that has
one already (a test, ``chip_smoke.py``) runs the dry run as a child
process.

For each cell this produces:
  * proof the sharded step runs (its shapes, placements and collectives
    agree on rank 0),
  * ``memory``: the bytes of rank 0's local shards of the arguments and
    outputs, and ``temp_bytes``: the peak of the bytes of storages the
    step created that were alive at once (``OpStats.peak_bytes``; one
    rank's, so ``temp_bytes_per_device`` is the same number, where the
    reference divides XLA's total by the chips),
  * ``xla_cost_analysis``: null (there is no XLA), kept for the
    reference's keys,
  * the op count's FLOPs, bytes and collective bytes of rank 0's step,
  * the three-term roofline row (``roofline.report``, H100 constants).
``lower_s`` is the wall to build the step and place its arguments,
``compile_s`` the wall of the counted call.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi    # 2x16x16 only

Results are written incrementally to benchmarks/results/torch/dryrun.json
so an interrupted sweep resumes where it left off (--force recounts).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch import sharding
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, list_archs, runnable_shapes
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import get_shape
from repro_torch.roofline import op_analysis
from repro_torch.roofline.report import (Roofline, model_flops,
                                         structural_memory_bytes)

RESULTS = str(Path(__file__).resolve().parents[3] / "benchmarks" / "results"
              / "torch" / "dryrun.json")
#: Ranks of the fake group: the two-pod mesh's; the one-pod mesh takes the
#: first 256.
WORLD = 512


def init_fake_group(world: int = WORLD) -> None:
    """Start this process's default group as rank 0 of `world` fake
    ranks, unless a group of that many ranks is up already."""
    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already up; the dry run needs {world} (run it in a "
                f"process of its own)")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _place(args, in_pl, mesh):
    """The step's arguments as a caller passes them: the state, params
    and cache as DTensors with their placements; the batch and tokens
    global (every rank passes the same)."""
    if isinstance(args[0], dict) and "opt" in args[0]:      # train
        return (sharding.distribute_tree(args[0], mesh, in_pl[0]), args[1])
    params = sharding.distribute_tree(args[0], mesh, in_pl[0])
    if len(args) == 2:                                       # prefill
        return params, args[1]
    cache = tree_lib.map_leaves(
        lambda t, p: sharding.distribute(t, mesh, p)
        if isinstance(t, torch.Tensor) else t, args[2], in_pl[2])
    return params, args[1], cache


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             layout: str = "tp", kv_dtype: str = "model") -> dict:
    cfg = get_config(arch)
    if kv_dtype != "model":
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    shape = get_shape(shape_name)
    init_fake_group()
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.size()

    t0 = time.time()
    fn, args, in_pl, _ = steps_lib.build_step(cfg, shape, mesh,
                                              layout=layout)
    call = _place(args, in_pl, mesh)
    t_lower = time.time() - t0
    t0 = time.time()
    out, stats = op_analysis.analyze(fn, *call)
    t_compile = time.time() - t0

    mf = model_flops(cfg, shape, shape.kind)
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    mem_model = structural_memory_bytes(cfg, shape, shape.kind, mesh_shape)
    roof = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=stats.flops,
        bytes_per_device=stats.bytes_accessed,
        collective_bytes_per_device=stats.total_collective_bytes,
        collective_breakdown=dict(stats.collective_bytes),
        model_flops_total=mf,
        memory_model_bytes=mem_model,
    )
    return {
        "status": "ok",
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": _local_bytes(call),
            "output_bytes": _local_bytes(out),
            "temp_bytes": stats.peak_bytes,
            "temp_bytes_per_device": stats.peak_bytes,
        },
        "xla_cost_analysis": {
            "flops_uncorrected": None,
            "bytes_uncorrected": None,
            "note": "no XLA in the port: the counts are the dispatch "
                    "mode's (op_analysis)",
        },
        "hlo_dot_count": stats.dot_count,
        "roofline": roof.row(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "swep"])
    ap.add_argument("--kv-dtype", default="model", choices=["model", "int8"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        shapes = ([args.shape] if args.shape else runnable_shapes(arch))
        all_shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
        for shape_name in (all_shapes if not args.shape else shapes):
            for multi in meshes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                key = f"{arch}|{shape_name}|{mesh_name}"
                if args.layout != "tp":
                    key += f"|{args.layout}"
                if args.kv_dtype != "model":
                    key += f"|kv-{args.kv_dtype}"
                if shape_name not in shapes:
                    results[key] = {"status": "skipped(full-attention)",
                                    "reason": "no sub-quadratic mode"}
                    continue
                if key in results and results[key].get("status") == "ok" \
                        and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    row = run_cell(arch, shape_name, multi, args.layout,
                                   args.kv_dtype)
                    r = row["roofline"]
                    print(f"  ok: build={row['lower_s']}s "
                          f"count={row['compile_s']}s "
                          f"compute={r['compute_s']:.4f}s "
                          f"memory={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"dominant={r['dominant']} "
                          f"useful={r['useful_flops_ratio']:.3f} "
                          f"temp={row['memory']['temp_bytes'] / 1e9:.3f}GB",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    row = {"status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"  ERROR: {e!r}", flush=True)
                results[key] = row
                tmp = args.out + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(results, f, indent=1)
                os.replace(tmp, args.out)

    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    n_skip = sum(1 for v in results.values()
                 if str(v.get("status", "")).startswith("skipped"))
    n_err = sum(1 for v in results.values() if v.get("status") == "error")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
