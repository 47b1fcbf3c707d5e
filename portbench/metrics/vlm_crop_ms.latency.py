"""Host milliseconds per VLM pass enqueuing the crop geometry on the card:
the program's span ``vx.vlm.crop`` per ``vx.vlm``, over the profiled
slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.vlm.crop"], "vx.vlm")
