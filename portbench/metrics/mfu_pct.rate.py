"""Model FLOPs (harness/flops.py) of the units completed in the window over the
window's seconds at the H100's bf16 peak, in percent."""

from portbench.metrics._readers import mfu_pct


def read(record):
    return mfu_pct(record)
