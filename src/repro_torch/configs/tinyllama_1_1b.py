"""tinyllama-1.1b [dense] llama2-arch small [arXiv:2401.02385; hf]:
22L d_model=2048 32H (kv=4) d_ff=5632 vocab=32000. KV replicate 4x."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="tinyllama-1.1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=128,
)
