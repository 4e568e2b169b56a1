"""qwen2-moe-a2.7b [moe] [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048
16H (kv=16) expert_ff=1408 vocab=151936, 4 shared + 60 routed top-4.
60 experts pad to 64 for EP16 (pad experts never win routing)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=151936,
    moe_experts=60, moe_shared=4, moe_top_k=4, moe_d_ff=1408,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=128,
    moe_experts=6, moe_shared=1, moe_top_k=2, moe_d_ff=32,
)
