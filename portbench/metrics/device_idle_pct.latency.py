"""Share of the window with no kernel, copy or memset on the device: 1 -
(device busy time per unit in the traced slice, the union of the profiler's
device intervals) / (wall time per unit of the run's untraced window)."""

from portbench.metrics._readers import device_idle_pct


def read(record):
    return device_idle_pct(record)
