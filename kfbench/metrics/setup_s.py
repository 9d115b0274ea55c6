"""Seconds from launch to the first timed step: imports, the CUDA
context, the NCCL world, weights and batches, the checked first steps
and the warm-up (and on a first run, the kernels' build)."""


def read(record):
    return record["setup_s"]
