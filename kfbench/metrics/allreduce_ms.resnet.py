"""Device ms a step of NCCL kernels (the gradient and statistics
averages) on the rank where they took least: the rank that reached them
last, so the least waiting for the others is counted; nothing on a world
of one."""

from kfbench import readers


def read(record):
    return readers.device_ms_least(record, readers.is_nccl)
