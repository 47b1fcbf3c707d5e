"""K3's roofline share in the traced slice: its bound per call
(harness/flops.py) over the device time of its tail_conv, tail_trans_stats
and the stats_combine that follows it."""

from portbench.metrics._readers import k3_device_s, roofline_pct


def read(record):
    return roofline_pct(record, "k3_bound_s", k3_device_s)
