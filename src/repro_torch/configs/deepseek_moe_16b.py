"""deepseek-moe-16b [moe]: fine-grained MoE [arXiv:2401.06066; hf].
28L d_model=2048 16H (kv=16) expert_ff=1408 vocab=102400, 2 shared +
64 routed top-6. Uniform-MoE simplification: the paper's first dense layer
is made MoE to keep scan-over-layers homogeneous (noted in DESIGN.md)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=102400,
    moe_experts=64, moe_shared=2, moe_top_k=6, moe_d_ff=1408,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=128,
    moe_experts=8, moe_shared=2, moe_top_k=2, moe_d_ff=32,
)
