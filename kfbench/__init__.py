"""kfbench: the benchmark of kungfu_tpu_torch (see BENCHMARK.json and
kfbench/run.py)."""
