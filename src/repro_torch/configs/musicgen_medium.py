"""musicgen-medium [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. 48L d_model=1536 24H (GQA kv=24 = MHA) d_ff=6144
vocab=2048. Backbone only; the EnCodec frontend is a stub (input_specs
provides precomputed frame embeddings). Absolute sinusoidal positions,
GELU MLP. 24 heads pad to 32 for TP16 (DESIGN.md §3)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense", frontend="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, pos_emb="sinusoidal", act="gelu",
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="dense", frontend="audio",
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=3, head_dim=32,
    d_ff=192, vocab_size=128, pos_emb="sinusoidal", act="gelu",
)
