"""Tokens trained per second per card, over the whole window: all
ranks' tokens over the window's host seconds, over the cards."""

from kfbench import readers


def read(record):
    return readers.rate(record)
