"""The 95th percentile of every window step's time: the gap between
consecutive step-end events on the card, at the slowest rank."""

from kfbench import readers


def read(record):
    return readers.percentile(readers.step_times_ms(record), 95)
