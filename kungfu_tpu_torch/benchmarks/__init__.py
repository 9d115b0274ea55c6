"""Allreduce and telemetry benchmarks (`python -m kungfu_tpu_torch.benchmarks`).
Port of `kungfu_tpu/benchmarks/`."""
