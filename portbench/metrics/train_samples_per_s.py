"""Samples of every update completed in the window over the window's seconds;
the window ends in a synchronise."""

from portbench.metrics._readers import per_second


def read(record):
    return per_second(record)
