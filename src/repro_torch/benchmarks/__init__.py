"""Benchmarks of the port (ports of the reference's ``benchmarks/``), run
as modules: ``python -m repro_torch.benchmarks.<name> --device ...``."""
