"""Benchmarks of the port (``python -m repro_torch.benchmarks.<name>``)."""
