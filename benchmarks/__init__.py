"""The benchmark of sar_tpu_torch: `python -m benchmarks.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
