"""The attention forward's least time over its device time in the profiled
scoring requests, in %."""

from portbench.core import roofline


def read(records):
    return roofline.share(records, "attn_fwd", "score")
