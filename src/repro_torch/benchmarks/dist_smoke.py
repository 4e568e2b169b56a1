"""The distribution layer's checks: several ranks on the CPU, one on a card.

Multi-rank cases on CPU ranks (gloo), each rank a process:

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.benchmarks.dist_smoke --device cpu \\
      --inputs in.npz --out out.npz

Every rank reads the same inputs (numpy arrays, made from a seed by the
caller, ``tests/test_torch_dist.py``, which runs the reference on the
same arrays); rank 0 writes what the ranks computed, gathered whole. The
cases, on a (2, 2) ("data", "model") mesh unless said:

* ``ep_*``: ``granularity.sw_plus_ep_layer`` (block 8) at each capacity
  factor of the inputs: the output and aux; at the first, the gradients
  of ``sum(y * ct)`` (each rank adds its share) as the sum of the ranks'.
* ``decode``: ``granularity.seq_sharded_decode_attention``, the cache
  split by sequence over "model".
* ``compress``: ``compression.compressed_psum_grads`` over a 1-D mesh of
  ranks 0 and 1 (rank r passes replica r).
* ``step_<case>``, one a case the inputs name (its layout and config):
  ``steps.build_step``'s train step: the loss, metrics and whole
  gradients of ``steps.mesh_loss_and_grads``, then one step, after which
  every rank's shards of params and AdamW moments must have the shapes
  their specs give; and the prefill and decode arms' logits and cache,
  gathered whole. A ``sw_plus`` MoE (K3 and K4 have no backward) gives
  ``steps.mesh_loss``'s loss and metrics and its arms. Beside them, the
  collectives ``launch.mesh`` issued in the gradient and in the arms, by
  axis and kind, and the names the sharder checked in a loss and
  gradient of the case (each a local block of its spec, or it raises).
* ``live_<remat>``: a dense config of :data:`LIVE_LAYERS` layers under
  ``fsdp``, one loss and gradient: the most layers whose gathered weights
  were alive at once (``Sharder.max_live_layers``).
* ``elastic``: a state on the (2, 2) mesh saved with ``ckpt.save`` and
  ``elastic.recover``-ed onto a mesh of ranks 0 and 1: equal bit for bit
  there, no state on ranks 2 and 3.

On a card (a world of one, NCCL), ``chip_smoke.py``'s distribution
phase calls :func:`dense_step_check` (a), :func:`moe_check` (b),
:func:`compression_check` (c), :func:`elastic_check` (d),
:func:`decode_check` (e) and :func:`rank0_check` (f); each raises
AssertionError on a failure. (f) runs, in a child process
(``--rank0``), rank 0's real local step of the dry run's
:data:`RANK0_CELL` under ``tp``: rank 0 of ``launch.dryrun``'s fake
group of 512 ranks (its collectives move nothing, so the values are not
checked), with its own shards of the state on the card, drawn from a
seed, and its rows of the global batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch import sharding
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.core import granularity
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import convert, moe as moe_mod
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw, compression
from repro_torch.runtime import elastic

#: Layers of the ``live_*`` cases.
LIVE_LAYERS = 4
#: The layer's tolerance (the reference's, ``tests/test_granularity.py``).
EP_TOL = (1e-4, 1e-5)
DECODE_TOL = (1e-5, 1e-5)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _cfg(inputs, key: str) -> ModelConfig:
    return ModelConfig(**json.loads(str(inputs[key]))).validate()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree(inputs, prefix: str) -> Dict[str, Any]:
    """The numpy tree stored flat under ``prefix/<path>`` keys."""
    return tree_lib.unflatten(
        (tuple(k[len(prefix) + 1:].split("/")), inputs[k])
        for k in inputs.keys() if k.startswith(prefix + "/"))


def _all_ok(ok: bool) -> bool:
    """Whether `ok` holds on every rank."""
    t = torch.tensor([1 if ok else 0])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


# ---------------------------------------------------------------------------
# Multi-rank cases
# ---------------------------------------------------------------------------


def ep_case(inputs, mesh, out) -> None:
    """sw_plus_ep_layer at each capacity factor, and its gradients."""
    dp = ("data",)
    granularity.set_mesh(mesh, dp)
    layer = {k: torch.from_numpy(inputs["ep/" + k]) for k in
             ("router", "w1", "w3", "w2")}
    x_all = torch.from_numpy(inputs["ep/x"])
    ct_all = torch.from_numpy(inputs["ep/ct"])
    tp = mesh_lib.axis_size(mesh, "model")
    for i, cf in enumerate(inputs["ep/capacity_factors"]):
        cfg = dataclasses.replace(_cfg(inputs, "ep/cfg"),
                                  moe_capacity_factor=float(cf))
        params = {k: v.clone().requires_grad_(i == 0)
                  for k, v in layer.items()}
        x = sharding.local_block(x_all, mesh, dp).clone().requires_grad_(
            i == 0)
        y, aux = granularity.sw_plus_ep_layer(params, x, cfg, dp, block=8)
        y_full = torch.cat(_gather_rows(y.detach(), mesh, dp))
        out[f"ep/y{i}"] = _np(y_full)
        out[f"ep/aux{i}"] = _np(aux.detach())
        if i:
            continue
        ct = sharding.local_block(ct_all, mesh, dp)
        loss = (y * ct).sum() / tp
        loss.backward()
        for k, p in params.items():
            out[f"ep/d{k}"] = _np(mesh_lib.all_reduce(p.grad, mesh, "all"))
        dx = mesh_lib.all_reduce(x.grad, mesh, "model")
        out["ep/dx"] = _np(torch.cat(_gather_rows(dx, mesh, dp)))
    granularity.set_mesh(None)


def _gather_rows(t: torch.Tensor, mesh, dp) -> list:
    """Every data block's `t`, in block order (an all-gather over dp)."""
    group = mesh.get_group(dp[0])
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def decode_case(inputs, mesh, out) -> None:
    q = torch.from_numpy(inputs["decode/q"])
    k, v = (sharding.local_block(torch.from_numpy(inputs[f"decode/{n}"]),
                                 mesh, "model", 1) for n in ("k", "v"))
    positions = sharding.local_block(
        torch.from_numpy(inputs["decode/positions"]), mesh, "model", 0)
    o = granularity.seq_sharded_decode_attention(
        q, k, v, positions, int(inputs["decode/pos"]), mesh=mesh)
    out["decode/out"] = _np(o)


def compress_case(inputs, out) -> None:
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
    if not mesh_lib.member(mesh):
        return
    r = mesh.get_local_rank("data")
    grads = {"a": torch.from_numpy(inputs["compress/a"][r]),
             "b": torch.from_numpy(inputs["compress/b"][r]
                                   ).to(torch.bfloat16)}
    red = compression.compressed_psum_grads(grads, mesh, "data")
    out["compress/a"] = red["a"].numpy()
    out["compress/b_bits"] = red["b"].view(torch.int16).numpy()


def _expected_local_shape(shape, placements, mesh) -> tuple:
    """The local shape a spec's placements give this rank: nested
    ``torch.chunk`` cuts, mesh dims in order."""
    sizes = list(shape)
    for c, n, p in zip(mesh.get_coordinate(), mesh.shape, placements):
        if isinstance(p, Shard):
            chunk = -(-sizes[p.dim] // n)
            sizes[p.dim] = max(0, min(chunk, sizes[p.dim] - c * chunk))
    return tuple(sizes)


def _counts_json() -> str:
    """``launch.mesh``'s collective counts as JSON: {"axis/kind": n}."""
    return json.dumps({f"{a}/{k}": n for (a, k), n in
                       sorted(mesh_lib.collective_counts().items())})


def _probe(cfg, params, batch, mesh, dp, layout: str):
    """One loss and gradient of `cfg` in `layout` through a sharder of
    this call's own: the sharder (its ``checked`` names and
    ``max_live_layers``) after it."""
    rows = batch["tokens"].shape[0]
    sh = sharding.make_sharder(mesh, dp, layout).bind(params, rows=rows)
    local = steps._local_rows(batch, mesh, dp)
    with granularity.global_routing(sh.mesh, sh.dp):
        if cfg.moe_dispatch == "sw_plus":
            with torch.no_grad():
                model_lib.train_loss(steps._local_params(params), cfg,
                                     local, sh, **steps._share(local, sh))
        else:
            steps.loss_and_grads(cfg, steps._local_params(params), local,
                                 sh, **steps._share(local, sh))
    return sh


def step_case(inputs, mesh, out, case: str) -> None:
    """build_step's arms in `case`'s layout and config."""
    key = "step_" + case
    layout = str(inputs[key + "/layout"])
    cfg = _cfg(inputs, key + "/cfg")
    tokens = torch.from_numpy(inputs[key + "/tokens"])
    b, s = tokens.shape
    batch = {"tokens": tokens, "labels": tokens}
    fn, (st, bt), in_pl, out_pl = steps.build_step(
        cfg, ShapeConfig(name="t", seq_len=s, global_batch=b, kind="train"),
        mesh, adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4),
        layout)
    _require(all(t.device.type == "meta" for t in tree_lib.leaves(st)),
             "build_step allocated its example state")
    run_cfg = (dataclasses.replace(cfg, moe_dispatch="sw_plus_ep")
               if layout == "swep" else cfg)
    params = convert.params_from_numpy(_tree(inputs, key + "/params"),
                                       run_cfg, "cpu")
    dp = steps._layout_dp(mesh, b, layout)
    placed = sharding.distribute_tree(params, mesh, in_pl[0]["params"])
    sh = _probe(run_cfg, placed, batch, mesh, dp, layout)
    out[key + "/checked"] = json.dumps(sorted(sh.checked))
    mesh_lib.reset_counts()
    if cfg.moe_dispatch == "sw_plus":
        loss, metrics = steps.mesh_loss(cfg, placed, batch, mesh, dp,
                                        layout)
        out[key + "/counts"] = _counts_json()
        out[key + "/loss"] = _np(loss)
        for name, m in metrics.items():
            out[f"{key}/{name}"] = _np(m)
        _arms(inputs, mesh, out, key, cfg, layout)
        return
    state = sharding.distribute_tree(
        {"params": params, "opt": adamw.init(params)}, mesh, in_pl[0])
    loss, metrics, shards = steps.mesh_loss_and_grads(
        run_cfg, state["params"], batch, mesh, dp, layout=layout)
    out[key + "/counts"] = _counts_json()
    out[key + "/loss"] = _np(loss)
    for name, m in metrics.items():
        out[f"{key}/{name}"] = _np(m)
    for (path, p), g in zip(tree_lib.flatten(state["params"]), shards):
        whole = sharding.full_tensor(DTensor.from_local(
            g, mesh, p.placements, run_check=False, shape=p.shape,
            stride=p.stride()))
        out[f"{key}/grads/" + "/".join(path)] = _np(whole)
    state, m = fn(state, batch)
    out[key + "/step_loss"] = _np(m["loss"])
    out[key + "/grad_norm"] = _np(m["grad_norm"])
    ok = True
    for tree_name, tree in (("params", state["params"]),
                            ("m", state["opt"]["m"]),
                            ("v", state["opt"]["v"])):
        for path, t in tree_lib.flatten(tree):
            want = _expected_local_shape(t.shape, t.placements, mesh)
            if tuple(t.to_local().shape) != want:
                ok = False
                print(f"rank {dist.get_rank()}: {tree_name} {path} local "
                      f"{tuple(t.to_local().shape)}, spec gives {want}",
                      flush=True)
    out[key + "/shards_ok"] = np.asarray(_all_ok(ok))
    if layout != "swep":
        _arms(inputs, mesh, out, key, cfg, layout)
    granularity.set_mesh(None)


def _arms(inputs, mesh, out, key: str, cfg: ModelConfig, layout: str
          ) -> None:
    """The prefill and decode arms on the step's weights, and the
    collectives they issued."""
    ptoks = torch.from_numpy(inputs[key + "/prompt"])
    pshape = ShapeConfig(name="p", seq_len=int(inputs[key + "/max_len"]),
                         global_batch=ptoks.shape[0], kind="prefill")
    pre, (pp, pb), pin, pout = steps.build_step(cfg, pshape, mesh,
                                                layout=layout)
    dshape = dataclasses.replace(pshape, kind="decode")
    dec, _, din, dout = steps.build_step(cfg, dshape, mesh, layout=layout)
    params = sharding.distribute_tree(
        convert.params_from_numpy(_tree(inputs, key + "/params"), cfg,
                                  "cpu"), mesh, pin[0])
    mesh_lib.reset_counts()
    logits, cache = pre(params, {"tokens": ptoks})
    _require(tuple(logits.placements) == tuple(pout[0]),
             f"prefill logits placed {logits.placements}, not {pout[0]}")
    out[key + "/prefill_logits"] = _np(sharding.full_tensor(logits))
    nxt = torch.from_numpy(inputs[key + "/next"])
    logits, cache = dec(params, nxt, cache)
    out[key + "/arm_counts"] = _counts_json()
    out[key + "/decode_logits"] = _np(sharding.full_tensor(logits))
    if "kv" in cache:
        out[key + "/decode_k"] = _np(sharding.full_tensor(cache["kv"]["k"]))
    if "ssm" in cache:
        for name in ("h", "conv_x"):
            out[f"{key}/decode_{name}"] = _np(sharding.full_tensor(
                cache["ssm"][name]))
    granularity.set_mesh(None)


def live_case(inputs, mesh, out) -> None:
    """The most layers whose gathered weights were alive at once in one
    fsdp loss and gradient of :data:`LIVE_LAYERS` layers, per remat
    policy."""
    base = _cfg(inputs, "step_fsdp/cfg")
    tokens = torch.from_numpy(inputs["step_fsdp/tokens"])
    batch = {"tokens": tokens, "labels": tokens}
    dp = steps._layout_dp(mesh, tokens.shape[0], "fsdp")
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, n_layers=LIVE_LAYERS, remat=remat)
        params = model_lib.init_params(cfg, 0, "cpu")
        placed = sharding.distribute_tree(params, mesh, sharding.to_placements(
            mesh, sharding.param_specs(params, "fsdp")))
        sh = _probe(cfg, placed, batch, mesh, dp, "fsdp")
        out[f"live_{remat}"] = np.asarray(sh.max_live_layers)


def elastic_case(inputs, mesh, out, workdir: str) -> None:
    cfg = _cfg(inputs, "step_tp/cfg")
    params = convert.params_from_numpy(_tree(inputs, "step_tp/params"), cfg,
                                       "cpu")
    state = {"params": params, "opt": adamw.init(params)}
    saved = tree_lib.map_leaves(lambda t: t.clone(), state)
    placed = sharding.distribute_tree(state, mesh, sharding.to_placements(
        mesh, sharding.state_specs(params)))
    ckpt.save(workdir, 5, placed)
    dist.barrier()
    target = steps.state_struct(cfg)
    new, step, new_mesh = elastic.recover(
        workdir, lambda: None, target, model_parallel=1, ranks=[0, 1],
        device="cpu")
    if mesh_lib.member(new_mesh):
        whole = tree_lib.map_leaves(sharding.full_tensor, new)
        ok = step == 5 and all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(saved), tree_lib.leaves(whole)))
        ok = ok and tuple(new_mesh.shape) == (2, 1)
    else:
        ok = new is None
    out["elastic/ok"] = np.asarray(_all_ok(ok))


def run_cases(inputs_path: str, out_path: str) -> None:
    mesh_lib.init_process_group("cpu")
    inputs = np.load(inputs_path)
    mesh = mesh_lib.make_host_mesh(2, "cpu")
    out: Dict[str, np.ndarray] = {}
    ep_case(inputs, mesh, out)
    decode_case(inputs, mesh, out)
    compress_case(inputs, out)
    for case in json.loads(str(inputs["step_cases"])):
        step_case(inputs, mesh, out, case)
    live_case(inputs, mesh, out)
    workdir = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                           "elastic_ckpt")
    elastic_case(inputs, mesh, out, workdir)
    dist.barrier()
    if dist.get_rank() == 0:
        np.savez(out_path, **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The card's phase (a world of one)
# ---------------------------------------------------------------------------

#: (a): the full-width training run's arguments (``train_smoke``), and the
#: steps each path takes; the walls are the median of steps 1 on.
DENSE_STEPS = 4
#: (a): the mesh step's slack on the plain step's wall and peak memory.
SLACK = 0.05
#: (b): the MoE layer's check: tokens, and the capacity factor of the
#: reference's oracle test (no assignment dropped); the swep train steps:
#: layers (the only cut), batch, sequence length, steps.
MOE_TOKENS = (2, 1024)
MOE_ORACLE_CF = 8.0
SWEP_LAYERS, SWEP_BATCH, SWEP_SEQ, SWEP_STEPS = 2, 4, 512, 3
#: (e): the sequence-sharded decode's shape and filled slots.
DECODE_SHAPE = dict(b=8, sc=4096, h=16, hd=128, filled=3000)
#: (f): the dry-run cell whose rank 0 runs its local step on the card
#: (arch, shape, layout), the steps (the wall is the median of steps 2
#: on) and one card's memory, which its peak must stay under.
RANK0_CELL = ("tinyllama-1.1b", "train_4k", "tp")
RANK0_STEPS = 3
CARD_BYTES = 80e9


def _timed_steps(step_fn, state, get_batch, n: int, device):
    """`n` steps from `state`: (state, losses, grad norms, walls)."""
    losses, norms, walls = [], [], []
    for i in range(n):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, get_batch(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return state, losses, norms, walls


def dense_step_check(device) -> dict:
    """(a) ``tinyllama-1.1b`` at full width through ``build_step(...,
    layout="tp")`` on a (1, 1) mesh against the plain step of the
    training slice, from the same seed and batches: losses and grad norms
    bit for bit; step wall and peak memory within :data:`SLACK`. Returns
    both paths' numbers (``"plain"``, ``"mesh"``) and the mesh path's
    state, ``"device_mesh"`` and batch function (for (c))."""
    from repro_torch.benchmarks import train_smoke
    from repro_torch.launch import train
    from repro_torch.configs import get_config

    args = train.parse_args(train_smoke.FULL_WIDTH_ARGS
                            + ["--device", str(device)])
    cfg = get_config(args.arch)
    get_batch = train.batch_fn(args, cfg, device)
    out = {}
    for name in ("plain", "mesh"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        if name == "plain":
            fn = train.make_accum_train_step(cfg, train.opt_config(args),
                                             args.accum)
            state = train.init_state(cfg, args.seed, device)
        else:
            mesh = mesh_lib.make_host_mesh(1, device)
            shape = ShapeConfig(name="train", seq_len=args.seq_len,
                                global_batch=args.batch, kind="train")
            fn, _, in_pl, _ = steps.build_step(
                cfg, shape, mesh, train.opt_config(args), "tp",
                accum=args.accum)
            state = sharding.distribute_tree(
                train.init_state(cfg, args.seed, device), mesh, in_pl[0])
        state, losses, norms, walls = _timed_steps(fn, state, get_batch,
                                                   DENSE_STEPS, device)
        wall = statistics.median(walls[1:])
        out[name] = {"losses": losses, "grad_norms": norms, "walls": walls,
                     "step_s": wall,
                     "tokens_per_s": args.batch * args.seq_len / wall,
                     "peak_bytes": torch.cuda.max_memory_allocated(device)}
        if name == "plain":
            del state, fn
    p, m = out["plain"], out["mesh"]
    _require(m["losses"] == p["losses"] and m["grad_norms"] == p["grad_norms"],
             f"mesh step {m['losses']} / {m['grad_norms']} != plain step "
             f"{p['losses']} / {p['grad_norms']}")
    _require(all(math.isfinite(x) for x in m["losses"]), "losses not finite")
    for key in ("step_s", "peak_bytes"):
        _require(m[key] <= (1 + SLACK) * p[key],
                 f"mesh step {key} {m[key]} over plain {p[key]} + "
                 f"{SLACK:.0%}")
    out.update(cfg=cfg, args=args, state=state, device_mesh=mesh,
               get_batch=get_batch)
    return out


def compression_check(cfg, args, state, mesh, get_batch) -> dict:
    """(c) ``compressed_psum_grads`` over the mesh's "data" group on a
    gradient of (a)'s mesh state: every leaf equal to ``dequantize(
    quantize(g))`` bit for bit."""
    dp = sharding.data_axes(mesh, args.batch)
    _, _, shards = steps.mesh_loss_and_grads(
        cfg, state["params"], get_batch(DENSE_STEPS), mesh, dp, args.accum)
    grads = tree_lib.unflatten(
        (path, g) for (path, _), g in zip(tree_lib.flatten(state["params"]),
                                          shards))
    del shards
    red = compression.compressed_psum_grads(grads, mesh, "data")
    n = 0
    for (path, g), r in zip(tree_lib.flatten(grads), tree_lib.leaves(red)):
        q, scale = compression.quantize(g)
        want = compression.dequantize(q, scale, g.dtype)
        _require(torch.equal(r, want), f"compressed {path} != "
                 f"dequantize(quantize(g))")
        n += g.numel()
    return {"leaves": len(tree_lib.leaves(grads)), "elements": n,
            "dtype": str(tree_lib.leaves(grads)[0].dtype)}


def moe_check(device) -> dict:
    """(b) ``qwen2-moe-a2.7b`` at full width: one MoE layer's forward
    (float32, :data:`MOE_TOKENS`, no grad) through ``sw_plus_ep_layer``
    against ``dispatch_dense_oracle`` and against ``dispatch_sw_plus`` on
    K3 + K4, at :data:`EP_TOL`; then :data:`SWEP_STEPS` ``swep`` train
    steps of the config cut to :data:`SWEP_LAYERS` layers (bf16): finite
    losses, the step wall, tokens/s and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import Init

    cfg = get_config("qwen2-moe-a2.7b")
    mesh = mesh_lib.make_host_mesh(1, device)
    out: Dict[str, Any] = {"cfg": cfg}
    with torch.no_grad():
        fcfg = dataclasses.replace(cfg, dtype="float32",
                                   moe_capacity_factor=MOE_ORACLE_CF)
        layer = moe_mod.moe_init(Init(0, device), fcfg, torch.float32)
        gen = torch.Generator(device=device).manual_seed(1)
        x = torch.randn(*MOE_TOKENS, cfg.d_model, generator=gen,
                        device=device)
        granularity.set_mesh(mesh, ("data",))
        y_ep, aux_ep = granularity.sw_plus_ep_layer(layer, x, fcfg)
        y_ep = y_ep.reshape(-1, cfg.d_model)
        flat = x.reshape(-1, cfg.d_model)
        for name, fn in (("oracle", moe_mod.dispatch_dense_oracle),
                         ("sw_plus", moe_mod.dispatch_sw_plus)):
            want, aux = fn(layer, flat, fcfg)
            err = (y_ep - want).abs()
            ok = bool((err <= EP_TOL[1] + EP_TOL[0] * want.abs()).all())
            _require(ok, f"sw_plus_ep_layer vs {name}: max abs err "
                     f"{float(err.max())}")
            _require(torch.equal(aux_ep, aux), f"aux vs {name}")
            out[f"max_abs_err_{name}"] = float(err.max())
            del want, err
        del layer, x, y_ep
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, n_layers=SWEP_LAYERS)
    torch.cuda.reset_peak_memory_stats(device)
    shape = ShapeConfig(name="train", seq_len=SWEP_SEQ,
                        global_batch=SWEP_BATCH, kind="train")
    fn, _, in_pl, _ = steps.build_step(
        tcfg, shape, mesh, adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=SWEP_STEPS),
        "swep")
    params = model_lib.init_params(tcfg, 0, device)
    state = sharding.distribute_tree(
        {"params": params, "opt": adamw.init(params)}, mesh, in_pl[0])
    del params
    gen = torch.Generator().manual_seed(0)

    def get_batch(i):
        toks = torch.randint(0, cfg.vocab_size, (SWEP_BATCH, SWEP_SEQ),
                             generator=gen).to(device)
        return {"tokens": toks, "labels": toks}

    state, losses, _, walls = _timed_steps(fn, state, get_batch,
                                           SWEP_STEPS, device)
    _require(all(math.isfinite(x) for x in losses),
             f"swep losses not finite: {losses}")
    wall = statistics.median(walls[1:])
    out.update(swep_losses=losses, swep_walls=walls, swep_step_s=wall,
               swep_tokens_per_s=SWEP_BATCH * SWEP_SEQ / wall,
               swep_peak_bytes=torch.cuda.max_memory_allocated(device),
               swep_cfg=tcfg)
    granularity.set_mesh(None)
    return out


def elastic_check(device, workdir: str) -> dict:
    """(d) A state of ``tinyllama-1.1b`` at full width and 2 layers (the
    drill's cut: a 1.6 GB checkpoint) after one mesh step, saved, then
    ``elastic.recover``-ed onto a rebuilt (1, 1) mesh: bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.benchmarks import train_smoke

    args = train.parse_args(train_smoke.FULL_WIDTH_ARGS
                            + ["--device", str(device)])
    cfg = dataclasses.replace(get_config(args.arch), n_layers=2)
    mesh = mesh_lib.make_host_mesh(1, device)
    fn, _, in_pl, _ = steps.build_step(
        cfg, ShapeConfig(name="train", seq_len=args.seq_len,
                         global_batch=args.batch, kind="train"),
        mesh, train.opt_config(args), "tp", accum=args.accum)
    state = sharding.distribute_tree(train.init_state(cfg, 0, device), mesh,
                                     in_pl[0])
    state, _ = fn(state, train.batch_fn(args, cfg, device)(0))
    t0 = time.perf_counter()
    ckpt.save(workdir, 1, state)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    new, step, new_mesh = elastic.recover(
        workdir, lambda: None, steps.state_struct(cfg), 1, None, device)
    torch.cuda.synchronize(device)
    t_recover = time.perf_counter() - t0
    _require(step == 1 and tuple(new_mesh.shape) == (1, 1),
             f"recovered step {step} on mesh {tuple(new_mesh.shape)}")
    for (path, a), b in zip(tree_lib.flatten(state), tree_lib.leaves(new)):
        _require(torch.equal(a.to_local(), b.to_local()),
                 f"recovered {path} differs")
    nbytes = sum(t.to_local().nbytes for t in tree_lib.leaves(state))
    return {"bytes": nbytes, "save_s": t_save, "recover_s": t_recover,
            "leaves": len(tree_lib.leaves(state))}


def decode_check(device) -> dict:
    """(e) ``seq_sharded_decode_attention`` on a (1, 1) mesh at
    :data:`DECODE_SHAPE` (float32, the slots past ``filled`` empty)
    against plain softmax attention, at :data:`DECODE_TOL`."""
    d = DECODE_SHAPE
    mesh = mesh_lib.make_host_mesh(1, device)
    gen = torch.Generator(device=device).manual_seed(2)
    q = torch.randn(d["b"], d["h"], d["hd"], generator=gen, device=device)
    k, v = (torch.randn(d["b"], d["sc"], d["h"], d["hd"], generator=gen,
                        device=device) for _ in range(2))
    positions = torch.arange(d["sc"], dtype=torch.int32, device=device)
    positions[d["filled"]:] = -1
    pos = d["filled"] - 1
    got = granularity.seq_sharded_decode_attention(q, k, v, positions, pos,
                                                   mesh=mesh)
    s = torch.einsum("bhd,bkhd->bhk", q / d["hd"] ** 0.5, k)
    valid = (positions >= 0) & (positions <= pos)
    s = s.masked_fill(~valid[None, None, :], -2.0e38)
    want = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, -1), v)
    err = (got - want).abs()
    _require(bool((err <= DECODE_TOL[1] + DECODE_TOL[0] * want.abs()).all()),
             f"seq-sharded decode: max abs err {float(err.max())}")
    return {"max_abs_err": float(err.max())}


def _rank0_state(struct: dict, placements: dict, mesh, device,
                 seed: int) -> dict:
    """Rank 0's shards of a train state of `struct` (meta tensors) laid
    out by `placements`, as DTensors on `device`: weights from a normal
    draw (x 0.02) seeded with `seed`, vectors (norms) ones, AdamW moments
    and step zeros."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def shard(path, t, pl):
        shape = _expected_local_shape(t.shape, pl, mesh)
        matrix = t.dim() - ("layers" in path) >= 2
        if path[0] != "params":
            local = torch.zeros(shape, dtype=t.dtype, device=device)
        elif matrix:
            local = (torch.randn(shape, generator=gen, device=device)
                     * 0.02).to(t.dtype)
        else:
            local = torch.ones(shape, dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape,
                                  stride=sharding._contiguous_stride(t.shape))

    flat_pl = dict(tree_lib.flatten(placements))
    return tree_lib.unflatten((path, shard(path, t, flat_pl[path]))
                              for path, t in tree_lib.flatten(struct))


def rank0_step(device, cfg=None, shape=None) -> dict:
    """(f), in a process of its own: rank 0's local step of
    :data:`RANK0_CELL` (or `cfg` and `shape`) on the production mesh
    (16x16), as the dry run builds it, run :data:`RANK0_STEPS` times on
    `device` with rank 0's shards and rows. Returns the walls, their
    median from step 2 on, the peak of ``torch.cuda.max_memory_allocated``
    (on a card) and the cell's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import get_shape

    arch, shape_name, layout = RANK0_CELL
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    dryrun.init_fake_group()
    device = model_lib.resolve_device(device)
    card = device.type == "cuda"
    mesh = mesh_lib.make_production_mesh(device=device)
    fn, (st, _), in_pl, _ = steps.build_step(cfg, shape, mesh,
                                             layout=layout)
    state = _rank0_state(st, in_pl[0], mesh, device, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                             shape.seq_len),
                         generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    dp = steps._layout_dp(mesh, shape.global_batch, layout)
    rows = sharding.local_block(toks, mesh, dp).shape[0]
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(RANK0_STEPS):
        if card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        float(m["loss"])
        if card:
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls[1:])
    return {"cell": f"{cfg.name}|{shape.name}|pod16x16|{layout}",
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "rows": rows, "seq_len": shape.seq_len, "walls": walls,
            "step_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if card else None,
            "state_bytes": sum(t.to_local().nbytes
                               for t in tree_lib.leaves(state)),
            "tokens_per_s": rows * shape.seq_len / wall}


def rank0_check(device, workdir: str) -> dict:
    """(f) :func:`rank0_step` in a child process (the fake group must be
    its process's default group): exit 0 and a peak under
    :data:`CARD_BYTES`; its numbers, and the child's wall."""
    from repro_torch.benchmarks import harness_smoke as hs

    child = hs.start("rank0", [sys.executable, "-m",
                               "repro_torch.benchmarks.dist_smoke",
                               "--rank0", "--device", str(device)], workdir)
    res = hs.finish(child, timeout=300)
    hs.check_finished("rank 0's local step", res)
    lines = [ln for ln in res["stdout"].splitlines() if ln.startswith("{")]
    _require(bool(lines), f"rank 0's step printed no result: "
             f"{res['stdout'][-2000:]}")
    out = dict(json.loads(lines[-1]), child_s=res["wall_s"])
    _require(out["peak_bytes"] < CARD_BYTES,
             f"rank 0's step peaked at {out['peak_bytes']} bytes, over "
             f"{CARD_BYTES:.0f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"),
                    help="the ranks' device: CPU ranks over gloo; cuda "
                    "for --rank0 alone")
    ap.add_argument("--inputs")
    ap.add_argument("--out")
    ap.add_argument("--rank0", action="store_true",
                    help="rank 0's local step of the dry run's "
                    "tinyllama-1.1b train cell under tp on the card, as "
                    "one JSON line")
    args = ap.parse_args(argv)
    if args.rank0:
        print(json.dumps(rank0_step(args.device)), flush=True)
        return
    if args.device != "cpu" or not (args.inputs and args.out):
        ap.error("the multi-rank cases take --device cpu, --inputs and "
                 "--out")
    run_cases(args.inputs, args.out)


if __name__ == "__main__":
    main()
