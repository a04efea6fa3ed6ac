"""The benchmark of adalog_tpu_torch (see run.py and BENCHMARK.json at the
root of the repository)."""
