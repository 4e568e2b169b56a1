"""mamba2-780m [ssm]: SSD (state-space duality) [arXiv:2405.21060].
48L d_model=1536 attn-free, ssm_state=128, vocab=50280 (padded 50432).
d_inner=3072, headdim=64 -> 48 SSD heads (48 % 16 == 0 for TP)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280, pos_emb="none",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, head_dim=16,
    d_ff=0, vocab_size=128, pos_emb="none",
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_chunk=32,
)
