"""K4's roofline share in the traced slice: the bound of its forward and
backward launches (harness/flops.py) over the device time of its train_fwd,
train_bwd_dq and train_bwd_dkv kernels."""

from portbench.metrics._readers import k4_device_s, roofline_pct


def read(record):
    return roofline_pct(record, "k4_bound_s", k4_device_s)
