"""Device operations (kernels, memcpy, memset) per scoring request of the
profiled stretch."""

from portbench.core import roofline


def read(records):
    return roofline.ops_per_unit(records, "score")
