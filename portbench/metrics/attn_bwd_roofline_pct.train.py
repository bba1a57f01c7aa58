"""The attention backward's least time over its device time in the profiled
training steps, in %."""

from portbench.core import roofline


def read(records):
    return roofline.share(records, "attn_bwd", "train")
