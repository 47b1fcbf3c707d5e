"""Host milliseconds per VLM pass in SAM's preprocess and image encoder: the
program's span ``vx.vlm.sam.encode`` per ``vx.vlm``, over the profiled
slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.vlm.sam.encode"], "vx.vlm")
