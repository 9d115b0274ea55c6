"""% of the flash backward's least time (dQ and dK/dV together,
kfbench/costs/bert.py) over the two kernels' device time."""

from kfbench import readers


def read(record):
    return readers.roofline(record, "flash_bwd_bound_s",
                            lambda op: readers.is_flash("dq")(op) or readers.is_flash("dkv")(op))
