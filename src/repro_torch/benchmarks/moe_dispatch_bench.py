"""MoE dispatch strategies: the paper's SW+/LW+ comparison on the LM side.

The port of ``benchmarks/moe_dispatch_bench.py``. For each strategy it
reports:
  * wall time per call (CUDA events on the card; the host clock with
    ``--device cpu``),
  * the *slot efficiency* = useful token-assignments / computed slots —
    LW+'s padded capacity buffers waste slots exactly like large warps
    waste lanes under divergence; SW+'s block-aligned sort wastes only
    the per-expert tile remainder (like small warps + ideal coalescing),
  * LW+'s token drop rate under its capacity.

Swept over routing imbalance ("divergence"): balanced routing (uniform)
vs skewed (Zipf) routers, with the reference's configuration (16
experts, top-2, d_model 256, moe_d_ff 256, capacity factor 1.25, float32)
on T = 4096 tokens. Weights and tokens are drawn on the host CPU from
``torch.Generator`` seeds and moved to the device, so a card and the CPU
route the same inputs. On the card SW+ (``moe.dispatch_sw_plus``, as the
serve calls it) launches K3 once and K4 three times a call.

Slot efficiencies and drop rates are integer counts of the routing
(:func:`lw_slot_efficiency`, :func:`sw_slot_efficiency`, the reference's
formulas); :func:`case` takes the params and tokens as arguments, so a
test can give both packages the same arrays.

    PYTHONPATH=src python -m repro_torch.benchmarks.moe_dispatch_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Init
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import resolve_device

Row = Tuple[str, float, float]
TOKENS = 4096
REPS = 3
#: (label, Zipf skew of the router's bias), as the reference sweeps them.
ROUTERS = (("balanced", 0.0), ("skewed", 1.0))
STRATEGIES = {"lw_plus": moe_mod.dispatch_lw_plus,
              "sw_plus": moe_mod.dispatch_sw_plus}


def _cfg(cap: float = 1.25) -> ModelConfig:
    return ModelConfig(
        name="bench-moe", family="moe", d_model=256, n_heads=4,
        n_kv_heads=4, head_dim=64, d_ff=0, vocab_size=256,
        moe_experts=16, moe_shared=0, moe_top_k=2, moe_d_ff=256,
        moe_capacity_factor=cap, dtype="float32").validate()


def skewed_router(params: dict, skew: float) -> dict:
    """Bias the router so expert popularity follows a Zipf-like curve."""
    e = params["router"].shape[1]
    bias = -skew * torch.log(torch.arange(1, e + 1, dtype=torch.float32,
                                          device=params["router"].device))
    return dict(params, router=params["router"] + bias[None, :] * 0.5)


def inputs(cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, dict]]:
    """The tokens and each router's layer params, on the host CPU."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((TOKENS, cfg.d_model), generator=gen)
    params = moe_mod.moe_init(Init(1, "cpu"), cfg, torch.float32)
    return x, {label: skewed_router(params, skew)
               for label, skew in ROUTERS}


def lw_slot_efficiency(cfg: ModelConfig, idx: np.ndarray, t: int) -> float:
    cap = moe_mod.capacity(cfg, t)
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=cfg.moe_experts_eff)
    return float(np.minimum(counts, cap).sum() / (cfg.moe_experts_eff * cap))


def sw_slot_efficiency(cfg: ModelConfig, idx: np.ndarray,
                       block: int = 128) -> float:
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=cfg.moe_experts_eff)
    padded = ((counts + block - 1) // block) * block
    return float(counts.sum() / max(padded.sum(), 1))


def lw_drop_rate(cfg: ModelConfig, idx: np.ndarray, t: int) -> float:
    flat = np.asarray(idx).reshape(-1)
    counts = np.bincount(flat, minlength=cfg.moe_experts_eff)
    cap = moe_mod.capacity(cfg, t)
    return float(np.maximum(counts - cap, 0).sum() / flat.size)


def lw_kept(cfg: ModelConfig, idx: torch.Tensor, t: int) -> torch.Tensor:
    """(T, k) bool: which assignments LW+ keeps under its capacity."""
    flat = idx.reshape(-1)
    onehot = moe_mod._one_hot(flat, cfg.moe_experts_eff)
    pos = torch.sum((torch.cumsum(onehot, 0) - 1) * onehot, -1)
    return (pos < moe_mod.capacity(cfg, t)).reshape(idx.shape)


def _timed(fn, device: torch.device, reps: int) -> Tuple[object, float]:
    """fn's last result and its wall per call in µs, after a warm-up (0
    with no repetition)."""
    out = fn()
    if not reps:
        return out, 0.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) / reps * 1e6


@torch.no_grad()
def case(params: dict, x: torch.Tensor, cfg: ModelConfig, device,
         reps: int = REPS) -> dict:
    """One router on `device`: its routing (idx and probs, on the host),
    each strategy's output and wall per call (µs), the slot efficiencies
    and LW+'s drop rate."""
    device = resolve_device(device)
    params = {k: v.to(device) for k, v in params.items()}
    x = x.to(device)
    t = x.shape[0]
    _, idx, _ = moe_mod.router_probs(params, x, cfg)
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    out = {"idx": idx.cpu(), "probs": probs.cpu(), "y": {}, "us": {}}
    for name, fn in STRATEGIES.items():
        y, us = _timed(lambda: fn(params, x, cfg)[0], device, reps)
        out["y"][name], out["us"][name] = y.cpu(), us
    idx_np = out["idx"].numpy()
    out["slot_eff"] = {"lw_plus": lw_slot_efficiency(cfg, idx_np, t),
                       "sw_plus": sw_slot_efficiency(cfg, idx_np)}
    out["drop_rate"] = lw_drop_rate(cfg, idx_np, t)
    return out


def rows(label: str, res: dict) -> List[Row]:
    return [(f"moe/{label}/{name}/slot_eff", res["us"][name],
             res["slot_eff"][name]) for name in STRATEGIES] + [
        (f"moe/{label}/lw_plus/drop_rate", 0.0, res["drop_rate"])]


def run(device="cuda") -> List[Row]:
    cfg = _cfg()
    x, routers = inputs(cfg)
    out: List[Row] = []
    for label, params in routers.items():
        out += rows(label, case(params, x, cfg, device))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    for name, us, derived in run(args.device):
        print(f"{name},{us:.1f},{derived:.6g}")


if __name__ == "__main__":
    main()
