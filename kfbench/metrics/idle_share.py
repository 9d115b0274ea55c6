"""% of the traced window in which the card ran nothing (1 - busy time
over the traced wall time), rank mean."""

from kfbench import readers


def read(record):
    return readers.idle_share(record)
