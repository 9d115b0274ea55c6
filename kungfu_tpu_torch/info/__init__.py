"""Environment/diagnostics report. Port of `kungfu_tpu/info/` (parity:
python -m kungfu.info, srcs/python/kungfu/info/__main__.py — the
CUDA/NCCL/TF versions become torch/CUDA/cluster facts)."""
