"""Host ms per scoring request in the app's conversion of the candidates
(the program's span ``convert``: bucketing by size, list to tensor), as a
mean over the last unprofiled requests (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "request",
                      lambda u: spans.span_ms(u, ("convert",)))
