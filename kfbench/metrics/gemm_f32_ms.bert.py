"""Device ms a step of float32 GEMM kernels (SIMT, no tensor cores):
today the tied LM head's forward and its two gradients."""

from kfbench import readers


def read(record):
    return readers.device_ms(record, readers.is_f32_gemm)
