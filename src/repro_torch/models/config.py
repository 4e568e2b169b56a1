"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid decoder LMs plus the
stubbed audio/VLM frontends. Per-arch instances live in
``repro_torch.configs``. ModelConfig and pad_to are copied from the
reference's ``repro.models.config`` (its ShapeConfig grid is not needed):
the tests hold every field and derived property equal to it.

Tensor-parallel divisibility: production meshes use a 16-way ``model`` axis.
Head counts and vocab sizes that do not divide it are *padded*:

* vocab is padded up to a multiple of ``vocab_pad_multiple`` (256);
* query heads are padded up to a multiple of ``tp_divisor`` (pad heads are
  zero-masked before the output projection, so they contribute nothing);
* KV heads are replicated ``tp/n_kv`` times when that is integral
  (mathematically identity for GQA), otherwise MHA-ified to match the
  padded query heads.

The resulting FLOP/byte overhead is intentional and visible in the
roofline "useful-FLOPs" ratio (DESIGN.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"           # dense | moe | ssm | hybrid
    frontend: Optional[str] = None  # None | "audio" | "vlm" (stub embeddings)

    # --- backbone ---
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab_size: int = 256
    pos_emb: str = "rope"           # rope | sinusoidal | none
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # tokens; None = full attention
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = True

    # --- MoE (family == "moe") ---
    moe_experts: int = 0            # routed experts
    moe_shared: int = 0             # always-on shared experts
    moe_top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "lw_plus"   # lw_plus (padded-dense) | sw_plus (sort-compact)

    # --- SSM (family in {"ssm", "hybrid"}) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256            # SSD chunk length

    # --- sharding / padding ---
    tp_divisor: int = 1             # model-axis size the config must divide
    vocab_pad_multiple: int = 256

    # --- numerics ---
    dtype: str = "bfloat16"
    remat: str = "none"             # none | dots | full
    kv_cache_dtype: str = "model"   # model (= dtype) | int8 (quantized KV)

    # ------------------------------------------------------------------
    # Derived (padded) dimensions
    # ------------------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        m = max(self.vocab_pad_multiple, self.tp_divisor)
        return pad_to(self.vocab_size, m)

    @property
    def n_q_eff(self) -> int:
        return pad_to(self.n_heads, self.tp_divisor)

    @property
    def n_kv_eff(self) -> int:
        """Effective stored KV heads after TP padding (see module docstring)."""
        kv, tp = self.n_kv_heads, self.tp_divisor
        if kv % tp == 0:
            out = kv
        elif tp % kv == 0:
            out = tp                       # replicate kv heads tp/kv times
        else:
            out = self.n_q_eff             # MHA-ify
        if self.n_q_eff % out:
            out = self.n_q_eff             # keep q-groups uniform
        return out

    @property
    def kv_repeat(self) -> int:
        """How many copies of each original KV head exist in storage."""
        if self.n_kv_eff == self.n_kv_heads:
            return 1
        if self.n_kv_eff == self.n_q_eff:
            return -1                      # MHA-ified (per-query mapping)
        return self.n_kv_eff // self.n_kv_heads

    @property
    def moe_experts_eff(self) -> int:
        """Routed experts padded to the TP divisor (pad experts never win
        routing: their router logits are fixed to -inf)."""
        if not self.moe_experts:
            return 0
        return pad_to(self.moe_experts, self.tp_divisor)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attn_dim(self) -> int:
        return self.n_q_eff * self.head_dim

    def validate(self) -> "ModelConfig":
        tp = self.tp_divisor
        assert self.d_model % max(tp, 1) == 0, (self.name, "d_model % tp")
        assert self.d_ff == 0 or self.d_ff % max(tp, 1) == 0, (self.name, "d_ff % tp")
        assert self.n_q_eff % self.n_kv_eff == 0, (self.name, "GQA groups")
        assert self.vocab_padded % max(tp, 1) == 0
        if self.family in ("ssm", "hybrid"):
            assert self.d_inner % self.ssm_headdim == 0
            if tp > 1:
                assert self.ssm_heads % tp == 0, (self.name, "ssm heads % tp")
        if self.family == "moe":
            assert self.moe_experts_eff % max(tp, 1) == 0
        return self

