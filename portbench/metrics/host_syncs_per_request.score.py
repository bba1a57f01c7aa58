"""Host synchronisations per scoring request that the program counts
(``telemetry.sync``: each chunk's copy to the device, the one copy back),
as a mean over the last unprofiled requests (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "request", spans.syncs)
