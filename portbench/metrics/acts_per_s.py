"""Acts of every call completed in the window over the window's seconds."""

from portbench.metrics._readers import per_second


def read(record):
    return per_second(record)
