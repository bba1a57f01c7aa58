"""Model FLOPs of a training step (work/model.py, training) over the wall time
per step of the window's epochs outside the profiled stretch, over the
card's dense peak in the compute dtype, in %."""

from portbench.core import roofline


def read(records):
    return roofline.mfu_pct(records, "train")
