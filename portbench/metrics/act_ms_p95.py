"""95th percentile of every act's host time in the window, observation dict to
action on the host."""

from portbench.metrics._readers import act_ms_p95


def read(record):
    return act_ms_p95(record)
