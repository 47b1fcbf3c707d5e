"""Milliseconds per update spent in the replay feed's next() (the benchmark's
span around it), over the traced run's window."""


def read(record):
    return 1e3 * record["data_wait_s"] / record["units"] if "data_wait_s" in record else None
