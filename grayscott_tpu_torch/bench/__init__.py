"""Benchmarks of the port: the throughput sweep (``harness``), the headline
4096^2 x 1000-step rows (``headline``) and their statistics (``stats``)."""
