"""llava-next-mistral-7b [vlm] anyres tiling [hf:llava-hf]: 32L
d_model=4096 32H (kv=8) d_ff=14336 vocab=32000. Backbone only — the vision
tower/anyres tiler is a stub; input_specs provides patch embeddings."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="dense", frontend="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    tp_divisor=16, remat="dots",
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke", family="dense", frontend="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
)
