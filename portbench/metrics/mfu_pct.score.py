"""Model FLOPs of a scoring request (work/model.py, forward) over the latency
of the window's requests outside the profiled stretch, over the card's
dense peak in the compute dtype, in %."""

from portbench.core import roofline


def read(records):
    return roofline.mfu_pct(records, "score")
