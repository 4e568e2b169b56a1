"""hymba-1.5b [hybrid] parallel attn+mamba heads [arXiv:2411.13676; hf]:
32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Adaptations (DESIGN.md §5): 25 q-heads pad to 32, kv=5 MHA-ifies for TP16;
sliding-window attention (2048) everywhere (Hymba mixes SWA + a few global
layers); SSD headdim=50 so d_inner=3200 -> 64 SSM heads (64 % 16 == 0)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, sliding_window=2048,
    ssm_state=16, ssm_expand=2, ssm_headdim=50, ssm_conv=4, ssm_chunk=256,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=128, sliding_window=32,
    ssm_state=8, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_chunk=16,
)
