"""Host ms per scoring request in the model: the program's spans
``encode`` (the node-table encode) and ``forward`` (the chunks, with their
copies to the device), as a mean over the last unprofiled requests
(``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "request",
                      lambda u: spans.span_ms(u, ("encode", "forward")))
