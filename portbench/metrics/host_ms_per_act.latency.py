"""Host milliseconds per act: the untraced window's wall time per act less the
traced slice's device busy time per act."""

from portbench.metrics._readers import host_ms_per_act


def read(record):
    return host_ms_per_act(record)
