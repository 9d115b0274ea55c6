"""% of the convolutions' least time (kfbench/costs/resnet.py: each
pass's max of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s) over the device
time of the kernels launched inside convolution operators."""

from kfbench import readers


def read(record):
    return readers.roofline(record, "conv_bound_s", readers.is_conv)
