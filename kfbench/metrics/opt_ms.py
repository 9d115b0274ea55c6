"""Device ms a step of the kernels launched under the optimizer's step
(the S-SGD wrapper and the base update; NCCL kernels left out), traced."""

from kfbench import readers


def read(record):
    return readers.device_ms(record, readers.in_range("kfbench.optimizer"))
