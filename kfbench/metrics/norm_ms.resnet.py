"""Device ms a step of batch-norm kernels (statistics, normalize and
their backward), by kernel name."""

from kfbench import readers


def read(record):
    return readers.device_ms(record, readers.is_norm)
