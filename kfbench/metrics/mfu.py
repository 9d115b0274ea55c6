"""% of the card's bf16 peak that the model's FLOPs (kfbench/costs)
fill over the whole unprofiled window."""

from kfbench import readers


def read(record):
    return readers.mfu(record)
