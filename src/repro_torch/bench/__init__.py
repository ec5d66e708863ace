"""Benchmarks of the port (``python -m repro_torch.bench.<module>``).

They live in the package, not under the repository's ``benchmarks/``,
because that harness imports the reference package.
"""
