"""Share of an untraced scoring request's time in which no kernel, memcpy or
memset ran on the device, in %: the device's busy time per request in the
profiled stretch over the latency of the window's other requests
(``core/roofline.py:idle_pct``)."""

from portbench.core import roofline


def read(records):
    return roofline.idle_pct(records, "score")
