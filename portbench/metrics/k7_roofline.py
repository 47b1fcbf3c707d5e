"""K7's roofline share in the traced slice: its bound per VLM pass
(harness/vlm_flops.py) over the device time of its launches. K7 and K2
are instantiations of one template (``attention_fwd<HD, NC, bias>``); K7's
alone carry the rel-pos bias (``true``), so the act's K2 launches are not
counted."""

from portbench.metrics._readers import roofline_pct


def k7_device_s(t):
    return sum(v for k, v in t["kernels"].items() if "attention_fwd<" in k and "true>" in k)


def read(record):
    return roofline_pct(record, "k7_bound_s", k7_device_s)
