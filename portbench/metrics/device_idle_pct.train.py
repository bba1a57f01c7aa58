"""Share of an untraced training step's time in which no kernel, memcpy or
memset ran on the device, in %: the device's busy time per step in the
profiled stretch over the wall time per step of the window's epochs outside
it (``core/roofline.py:idle_pct``)."""

from portbench.core import roofline


def read(records):
    return roofline.idle_pct(records, "train")
