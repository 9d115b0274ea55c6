"""Host ms to enqueue one step of the window (the trainer step's
Python and launches), rank mean."""

from kfbench import readers


def read(record):
    return readers.dispatch_ms(record)
