"""PyTorch / CUDA port of the reproduction (the JAX package ``repro`` is
its reference and is never imported from here)."""
