"""Host milliseconds per VLM pass in OWL-ViT's detection, its two copies to
the host included: the program's span ``vx.vlm.owl`` per ``vx.vlm``, over
the profiled slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.vlm.owl"], "vx.vlm")
