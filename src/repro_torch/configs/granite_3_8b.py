"""granite-3-8b [dense] GQA [hf:ibm-granite]: 40L d_model=4096 32H (kv=8)
d_ff=12800 vocab=49155 (padded 49408). KV heads replicate 2x for TP16."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
)
