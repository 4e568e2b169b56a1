"""Training driver: resume-first, fault-tolerant, straggler-monitored.

The port of ``repro.launch.train``, with the reference's flags, per-step
log lines and final JSON, plus ``--device`` (default ``cuda``; without a
card it raises rather than train on the CPU).

Usage (CPU-scale smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 50 --batch 8 --seq-len 128 --ckpt-dir /tmp/run1 \\
      --device cpu

At full width on one card (bf16, ``remat="dots"``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 6 --batch 8 --seq-len 2048 --accum 2

Features, as in the reference:
  * checkpoint/restart (resume_or_init + AsyncCheckpointer, atomic saves;
    the files are the reference's),
  * deterministic restorable data order (pure function of step),
  * failure injection (--fail-at) for restart drills,
  * straggler monitoring (median+6*MAD flagging; a step's clock stops
    once its loss has reached the host),
  * gradient accumulation (--accum): a loop over microbatches summing
    float32 gradients, one optimizer update,
  * a device mesh, as the reference's: ``make_host_mesh(--model-parallel)``
    over the ranks of the process group, the state laid out by
    ``sharding.param_specs`` and the step of ``launch.steps`` on it. One
    process is a world of one, a (1, 1) mesh; under ``torchrun`` every
    rank runs this driver, rank 0 prints and writes the checkpoints:
      torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
          --smoke --device cpu --model-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Optional

import torch.distributed as dist

from repro_torch import sharding
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.data.loader import to_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import fault, straggler


def make_accum_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                          accum: int):
    """Gradient-accumulated train step on one device, without a mesh: a
    loop over microbatches, one optimizer update. batch: (accum, b_micro,
    S) leading layout when `accum` > 1. Updates the state in place and
    returns it with ``{"loss", "grad_norm", "lr"}``."""

    def step_fn(state, batch):
        params = state["params"]
        loss, _, grads = steps.accumulate(
            lambda micro: steps.loss_and_grads(cfg, params, micro),
            params, batch, accum)
        new_params, new_opt, info = adamw.apply(
            opt_cfg, grads, state["opt"], params)
        out = {"loss": loss, **info}
        return {"params": new_params, "opt": new_opt}, out

    return step_fn


def init_state(cfg: ModelConfig, seed: int, device) -> dict:
    """Fresh ``{"params", "opt"}``: random weights from `seed` on
    `device`, zero moments."""
    params = model_lib.init_params(cfg, seed, device)
    return {"params": params, "opt": adamw.init(params)}


def opt_config(args: argparse.Namespace) -> adamw.AdamWConfig:
    """The driver's AdamW settings for `args` (the reference's)."""
    return adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                             total_steps=max(args.steps, 1))


def batch_fn(args: argparse.Namespace, cfg: ModelConfig, device
             ) -> Callable[[int], dict]:
    """step -> that step's batch on `device`, from the synthetic corpus of
    ``--seed``: tokens, or embeddings for the audio/VLM stub frontends;
    ``(accum, b_micro, S)`` leading layout when ``--accum`` > 1."""
    data = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=args.seed))
    use_embeds = cfg.frontend in ("audio", "vlm")

    def get_batch(step: int) -> dict:
        batch = (data.embeds_at(step, cfg.d_model) if use_embeds
                 else data.batch_at(step))
        batch = to_device(batch, device)
        if args.accum > 1:
            batch = {k: v.reshape(args.accum, -1, *v.shape[1:])
                     for k, v in batch.items()}
        return batch

    return get_batch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_args(argv))


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None
        ) -> dict:
    """Train as `args` say; `cfg` replaces the config of ``--arch`` (a
    caller's cut of it, such as fewer layers). Returns the final JSON's
    fields plus ``losses`` and ``step_s`` (each step's wall, in s)."""
    device = model_lib.resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
        cfg = dataclasses.replace(cfg, remat="none") if args.smoke else cfg
    mesh = mesh_lib.make_host_mesh(args.model_parallel, device)
    rank = dist.get_rank()
    if not mesh_lib.member(mesh):
        return {"first_loss": None, "last_loss": None, "losses": [],
                "straggler_events": 0, "final_step": args.steps,
                "step_s": []}
    dp = sharding.data_axes(mesh, args.batch)
    placements = sharding.to_placements(mesh, sharding.state_specs(
        steps.state_struct(cfg)["params"]))
    get_batch = batch_fn(args, cfg, device)

    start_step = 0
    if args.ckpt_dir:
        state, start_step = fault.resume_or_init(
            args.ckpt_dir, lambda: init_state(cfg, args.seed, device),
            steps.state_struct(cfg), device, mesh=mesh,
            placements=placements)
    else:
        state = sharding.distribute_tree(init_state(cfg, args.seed, device),
                                         mesh, placements)

    marker = "fail_marker" if rank == 0 else f"fail_marker.rank{rank}"
    injector = fault.FailureInjector(
        args.fail_at,
        marker_path=(os.path.join(args.ckpt_dir, marker)
                     if args.ckpt_dir else None))
    monitor = straggler.StragglerMonitor()
    saver = (ckpt.AsyncCheckpointer(args.ckpt_dir)
             if args.ckpt_dir else None)

    step_fn = steps.make_mesh_train_step(cfg, opt_config(args), mesh, dp,
                                         args.accum)

    losses, step_s = [], []
    try:
        for step in range(start_step, args.steps):
            injector.check(step)
            monitor.start_step()
            state, metrics = step_fn(state, get_batch(step))
            loss = float(metrics["loss"])
            monitor.end_step(step)
            step_s.append(monitor.window[-1])
            losses.append(loss)
            if rank == 0 and (step % args.log_every == 0
                              or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}",
                      flush=True)
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, state)
    except BaseException:
        # A crash (including an injected SimulatedFailure) must not abandon
        # an in-flight async checkpoint: the write the failing run already
        # started is the one a restart resumes from. Drain it, then
        # re-raise the real failure — a secondary checkpoint error must
        # not mask it.
        if saver:
            try:
                saver.wait()
            except Exception:
                pass
        raise
    if saver:
        saver.save(args.steps, state)
        saver.wait()
    result = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "losses": losses,
        "straggler_events": len(monitor.events),
        "final_step": args.steps,
        "step_s": step_s,
    }
    if rank == 0:
        print(json.dumps({k: v for k, v in result.items()
                          if k not in ("losses", "step_s")}))
    return result


if __name__ == "__main__":
    main()
