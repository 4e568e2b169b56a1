"""The training path's checks on a device: smoke steps against the CPU,
the kill/resume drill, a full-width run, and the kernels' autograd guard.

``chip_smoke.py``'s training phase and the ``gpu`` tests of
``tests/test_torch_train.py`` call these functions; each raises
``AssertionError`` on a failed check.

* :func:`check_smoke_steps`: one smoke config per family, float32, three
  train steps from the same numpy-drawn weights on the CPU and on the
  device: losses and grad norms within rtol 1e-4 (float32 sums in
  another order; the CPU side is held against the reference by the CPU
  tests).
* :func:`drill`: the reference's kill/resume drill (18 steps, a
  checkpoint every 6, a failure at 12) through ``launch.train``: the
  resumed losses must equal the uninterrupted run's bit for bit.
* :func:`full_width_run`: ``launch.train`` at full width
  (:data:`FULL_WIDTH_ARGS`: ``tinyllama-1.1b``, 6 steps of 8 x 2048
  tokens in 2 microbatches), its losses finite.
* :func:`check_autograd_guard`: K4 on device tensors that require grad
  raises ``NotImplementedError``, and launches under ``torch.no_grad()``.
* :func:`step_flops`: the products' operations of one train step, as
  the function needs them (the step's bound) and as the port computes
  them (its achieved rates).
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import statistics
import tempfile
from typing import Callable, Dict, List

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.data.loader import to_device
from repro_torch.launch import train
from repro_torch.models import attention, convert
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import fault

#: One smoke arch per family (the MoE with LW+ dispatch, the training
#: default: SW+ runs K3/K4, which have no backward).
SMOKE_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-780m",
               "hymba-1.5b")
SMOKE_RTOL = 1e-4
#: Train steps, batch and sequence length of a smoke run, and its seed.
SMOKE_STEPS, SMOKE_BATCH, SMOKE_SEQ_LEN, SMOKE_SEED = 3, 4, 32, 0
#: The reference's drill (``tests/test_integration.py``).
DRILL_ARGS = ["--steps", "18", "--batch", "4", "--seq-len", "64",
              "--ckpt-every", "6", "--log-every", "100"]
DRILL_FAIL_AT = 12
FULL_WIDTH_ARGS = ["--arch", "tinyllama-1.1b", "--steps", "6", "--batch",
                   "8", "--seq-len", "2048", "--accum", "2",
                   "--log-every", "1"]


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def smoke_config(arch: str) -> ModelConfig:
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", moe_dispatch="lw_plus")


def smoke_steps(arch: str, device) -> Dict[str, List[float]]:
    """:data:`SMOKE_STEPS` train steps of `arch`'s float32 smoke config on
    `device`, from numpy-drawn weights (``convert.numpy_params``) and the
    synthetic corpus, both of :data:`SMOKE_SEED`: each step's loss and
    grad norm."""
    cfg = smoke_config(arch)
    params = convert.params_from_numpy(
        convert.numpy_params(cfg, SMOKE_SEED), cfg, device)
    state = {"params": params, "opt": adamw.init(params)}
    step_fn = train.make_accum_train_step(
        cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                               total_steps=SMOKE_STEPS), accum=1)
    data = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SMOKE_SEQ_LEN,
        global_batch=SMOKE_BATCH, seed=SMOKE_SEED))
    out: Dict[str, List[float]] = {"loss": [], "grad_norm": []}
    for step in range(SMOKE_STEPS):
        b = (data.embeds_at(step, cfg.d_model) if cfg.frontend
             else data.batch_at(step))
        state, metrics = step_fn(state, to_device(b, device))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    return out


def check_smoke_steps(arch: str, device) -> Dict[str, Dict[str, List[float]]]:
    """:func:`smoke_steps` on the CPU and on `device`, held within
    :data:`SMOKE_RTOL`. Returns both."""
    cpu = smoke_steps(arch, "cpu")
    dev = smoke_steps(arch, device)
    for key in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(cpu[key], dev[key])):
            _require(math.isfinite(b) and abs(a - b) <= SMOKE_RTOL * abs(a),
                     f"{arch} step {i} {key}: {b} on {device}, {a} on the "
                     f"CPU")
    return {"cpu": cpu, "device": dev}


def drill(cfg: ModelConfig, device, workdir: str) -> Dict[str, List[float]]:
    """The kill/resume drill of `cfg` through ``launch.train.run``: an
    uninterrupted run, then one that fails at step 12 and its restart
    from the step-12 checkpoint. Checkpoints go to directories under
    `workdir`, removed after. Raises AssertionError unless the resumed
    losses equal the uninterrupted run's steps 12-17 bit for bit."""
    base = DRILL_ARGS + ["--device", str(device)]
    ref_dir = tempfile.mkdtemp(dir=workdir)
    try:
        ref = train.run(train.parse_args(base + ["--ckpt-dir", ref_dir]),
                        cfg)
    finally:
        shutil.rmtree(ref_dir)
    run_dir = tempfile.mkdtemp(dir=workdir)
    try:
        try:
            train.run(train.parse_args(
                base + ["--ckpt-dir", run_dir, "--fail-at",
                        str(DRILL_FAIL_AT)]), cfg)
        except fault.SimulatedFailure:
            pass
        else:
            raise AssertionError("the injected failure did not happen")
        resumed = train.run(train.parse_args(base + ["--ckpt-dir", run_dir]),
                            cfg)
    finally:
        shutil.rmtree(run_dir)
    want = ref["losses"][DRILL_FAIL_AT:]
    _require(resumed["losses"] == want,
             f"resumed losses {resumed['losses']} != uninterrupted {want}")
    return {"uninterrupted": ref["losses"], "resumed": resumed["losses"]}


def full_width_run(device) -> dict:
    """``launch.train`` at full width (:data:`FULL_WIDTH_ARGS`) on a card:
    the driver's result plus the median step wall of steps 2 on, tokens/s
    and peak memory. Raises AssertionError on a loss that is not
    finite."""
    args = train.parse_args(FULL_WIDTH_ARGS + ["--device", str(device)])
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    result = train.run(args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    _require(all(math.isfinite(x) for x in result["losses"]),
             f"losses not finite: {result['losses']}")
    wall = statistics.median(result["step_s"][2:])
    return dict(result, step_wall_s=wall,
                tokens_per_s=args.batch * args.seq_len / wall,
                peak_bytes=peak)


def traced_step(device) -> Callable[[], float]:
    """The full-width run's step as a closure, for a trace: a fresh state
    as ``launch.train`` builds it at :data:`FULL_WIDTH_ARGS`, one untimed
    step taken; each call runs the next step and returns its loss (on
    the host, as the driver reads it)."""
    args = train.parse_args(FULL_WIDTH_ARGS + ["--device", str(device)])
    cfg = get_config(args.arch)
    step_fn = train.make_accum_train_step(cfg, train.opt_config(args),
                                          args.accum)
    get_batch = train.batch_fn(args, cfg, device)
    held = {"state": train.init_state(cfg, args.seed, device), "step": 0}

    def step() -> float:
        held["state"], metrics = step_fn(held["state"],
                                         get_batch(held["step"]))
        held["step"] += 1
        return float(metrics["loss"])

    step()
    return step


def step_flops(cfg: ModelConfig, batch: int, seq_len: int
               ) -> Dict[str, float]:
    """Operations of the matrix products of one train step of a dense
    `cfg` over `batch` x `seq_len` tokens (``remat`` ``"none"`` or
    ``"dots"``, which recomputes no 2-D product):

    * ``"projections"``: the 2-D products (``aten.mm``): 6 x tokens x
      the weights of every layer's matrices and of the lm head;
    * ``"attention"``: the attention's products as the function needs
      them, over the causal keys (j <= i) only: 4 x B x heads x
      S(S+1)/2 x head_dim a layer in the forward, run three times
      (forward, two in the backward) and once more under ``dots``. With
      ``"projections"`` this is the step's bound;
    * ``"attention_computed"``: the chunked attention's batched einsums
      (``aten.bmm``) as the port runs them, the same but over every KV
      chunk in full (masked keys included).
    """
    if cfg.family != "dense" or cfg.remat not in ("none", "dots"):
        raise ValueError(f"step_flops counts dense configs with remat none "
                         f"or dots, not {cfg.family} / {cfg.remat}")
    struct = convert.param_struct(cfg)
    layer_weights = sum(t.numel() for t in tree_lib.leaves(struct["layers"])
                        if t.dim() == 3)
    head = cfg.d_model * cfg.vocab_padded
    chunk = min(attention.KV_CHUNK, seq_len)
    keys = -(-seq_len // chunk) * chunk
    per_pair = (4 * batch * cfg.n_q_eff * cfg.head_dim * cfg.n_layers
                * (4 if cfg.remat == "dots" else 3))
    return {"projections": 6.0 * batch * seq_len * (layer_weights + head),
            "attention": float(per_pair * seq_len * (seq_len + 1) // 2),
            "attention_computed": float(per_pair * seq_len * keys)}


def check_autograd_guard(device) -> None:
    """K4 (``kernels.ops.moe_gmm``) on device tensors that require grad
    raises NotImplementedError; under ``torch.no_grad()`` it launches."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    x = torch.randn(128, 64, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn(2, 64, 64, device=device, dtype=torch.bfloat16)
    be = torch.zeros(1, dtype=torch.int32, device=device)
    try:
        ops.moe_gmm(x, w, be, 128)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("moe_gmm ran on a tensor that requires grad")
    before = kernels.launch_count("gmm_kernel")
    with torch.no_grad():
        ops.moe_gmm(x, w, be, 128)
    torch.cuda.synchronize(device)
    _require(kernels.launch_count("gmm_kernel") == before + 1,
             "moe_gmm under torch.no_grad() did not launch K4")
