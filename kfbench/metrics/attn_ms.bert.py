"""Device ms a step of the three flash-attention kernels."""

from kfbench import readers


def read(record):
    return readers.device_ms(record, lambda op: "kf_flash" in op[0])
