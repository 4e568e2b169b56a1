"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407]:
88L d_model=12288 96H (kv=8) d_ff=28672 vocab=32768. The scale stressor:
123B params; scan-over-layers + FSDP(data) x TP(model) sharding."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768,
    tp_divisor=16, remat="full",
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=224, vocab_size=128,
)
