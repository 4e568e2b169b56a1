"""Three-term roofline report of one step, from the dry run's counts.

The port of ``repro.roofline.report``: the same rows and formulas, with
the constants of one NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, from
NVIDIA's H100 data sheet:

  PEAK_FLOPS = 989e12   dense BF16 on the tensor cores (no sparsity);
  HBM_BW     = 3.35e12  HBM3 bytes/s;
  ICI_BW     = 450e9    NVLink 4, 900 GB/s both ways, 450 GB/s each way.

There is one collective bandwidth, as the reference has one (its name is
kept, for the TPU's inter-chip links): it holds for mesh axes inside one
NVLink domain. Axes that span nodes run over InfiniBand, several times
slower, and the collective term understates them.

Terms (seconds, per device; the dry run counts one rank's step):
  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = collective_bytes / ICI_BW

MODEL_FLOPS (the "useful" floor) = 6*N*D for training (N = active params,
D = tokens) or 2*N_active per generated/prefilled token for serving;
ratio MODEL_FLOPS / (counted flops x chips) exposes padding/remat/
duplication waste.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16 / card
HBM_BW = 3.35e12             # bytes/s / card
ICI_BW = 450e9               # bytes/s / card, each way over NVLink 4


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float              # counted ops' bytes (cross-check)
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    model_flops_total: float
    memory_model_bytes: float = 0.0      # structural estimate (primary)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        """Primary memory term: structural estimate (see
        structural_memory_bytes); falls back to the counted bytes."""
        b = self.memory_model_bytes or self.bytes_per_device
        return b / HBM_BW

    @property
    def memory_hlo_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms (assumes
        perfect overlap of the other two)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total_hlo = self.flops_per_device * self.chips
        return self.model_flops_total / max(total_hlo, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the *useful* model FLOPs achieve at the
        roofline-optimistic step time (an MFU upper bound for this
        compiled program)."""
        if self.step_time_s <= 0:
            return 0.0
        achieved = self.model_flops_total / self.chips / self.step_time_s
        return achieved / PEAK_FLOPS

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_hlo_s": self.memory_hlo_s,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "memory_model_bytes": self.memory_model_bytes,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "model_flops_total": self.model_flops_total,
        }


def structural_memory_bytes(cfg, shape, kind: str, mesh_shape: dict) -> float:
    """Analytic per-device HBM traffic for one step.

    Used as the primary memory term: the dry run's byte count
    (``op_analysis``) is the eager program's, op by op, with every
    attention score materialised, which a fused kernel would never write.
    That count is still reported as a cross-check column (``memory_hlo_s``,
    the reference's name).

    Model: parameter shard traffic (+optimizer moments for training),
    activation traffic per layer (flash attention: scores never
    materialized), logits, KV/state cache.
    """
    data = mesh_shape.get("data", 1)
    model = mesh_shape.get("model", 1)
    pod = mesh_shape.get("pod", 1)
    # batch shards over (pod, data) when divisible; else replicated
    dp = pod * data if shape.global_batch % (pod * data) == 0 else (
        data if shape.global_batch % data == 0 else 1)

    p_total = count_params(cfg)
    p_loc = p_total / (data * model)          # FSDP x TP shard
    tokens_loc = shape.global_batch * (shape.seq_len if kind != "decode" else 1) / dp
    d = cfg.d_model

    if kind == "train":
        param_traffic = p_loc * (2 + 2 + 2 + 16)   # bf16 fwd/bwd/update + fp32 moments rw
    else:
        param_traffic = p_loc * 2                  # one bf16 read

    # activation traffic per token per layer (bf16), sharded over model where
    # applicable; k term: proj in/out, attn io, mlp io, norms, residuals.
    k_act = 14.0
    if cfg.family == "moe":
        k_act += 6.0 * cfg.moe_top_k * cfg.moe_d_ff / d
    if cfg.family in ("ssm", "hybrid"):
        k_act += 4.0 * cfg.ssm_expand
    remat_mult = {"none": 1.0, "dots": 1.5, "full": 2.0}[cfg.remat]
    fwd_bwd = 3.0 if kind == "train" else 1.0      # bwd ~2x fwd traffic
    act = (cfg.n_layers * tokens_loc * d * 2 * k_act / model
           * remat_mult * fwd_bwd)

    logits = tokens_loc * cfg.vocab_padded / model * 4 * (2 if kind == "train" else 0)
    if kind != "train":
        # last-position logits only
        logits = shape.global_batch / dp * cfg.vocab_padded / model * 4

    cache = 0.0
    if kind in ("decode", "prefill") and cfg.family in ("dense", "moe", "hybrid"):
        s_cache = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        kv_bytes = 1.02 if cfg.kv_cache_dtype == "int8" else 2.0
        cache = (cfg.n_layers * shape.global_batch / dp * s_cache
                 * cfg.n_kv_eff / model * cfg.head_dim * kv_bytes * 2)  # k+v
        if kind == "prefill":
            cache /= 2                                 # write once
    if kind == "decode" and cfg.family in ("ssm", "hybrid"):
        cache += (cfg.n_layers * shape.global_batch / dp * cfg.ssm_heads / model
                  * cfg.ssm_headdim * cfg.ssm_state * 4 * 2)

    return param_traffic + act + logits + cache


def count_params(cfg, active_only: bool = False) -> float:
    """Parameter count from a ModelConfig (embedding included once)."""
    d = cfg.d_model
    n = cfg.vocab_padded * d                      # embed (tied head)
    per_layer = 0.0
    if cfg.family in ("dense", "moe", "hybrid"):
        hd = cfg.head_dim
        per_layer += d * cfg.n_q_eff * hd * 2     # wq, wo
        per_layer += d * cfg.n_kv_eff * hd * 2    # wk, wv
    if cfg.family in ("dense", "hybrid"):
        mult = 3 if cfg.act == "swiglu" else 2
        per_layer += mult * d * cfg.d_ff
    if cfg.family == "moe":
        e_all = cfg.moe_experts_eff
        e_act = min(cfg.moe_top_k, cfg.moe_experts)
        e = e_act if active_only else e_all
        per_layer += 3 * d * cfg.moe_d_ff * e
        per_layer += 3 * d * cfg.moe_d_ff * cfg.moe_shared   # shared (always active)
        per_layer += d * e_all * (0 if active_only else 1)   # router
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        per_layer += 2 * d * di                   # z_proj, x_proj
        per_layer += d * (2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads)
        per_layer += di * d                       # out_proj
    return n + cfg.n_layers * per_layer


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS for one step of this cell.

    train:   6 * N_active * tokens
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch (one token per sequence)
    """
    n_active = count_params(cfg, active_only=True)
    if kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch
