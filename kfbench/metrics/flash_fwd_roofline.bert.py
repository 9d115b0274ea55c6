"""% of the flash forward's least time (kfbench/costs/bert.py) over its
kernels' device time."""

from kfbench import readers


def read(record):
    return readers.roofline(record, "flash_fwd_bound_s", readers.is_flash("fwd"))
