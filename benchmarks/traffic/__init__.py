"""Part of the benchmark harness (see benchmarks/README.md)."""
