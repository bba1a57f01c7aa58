"""Host ms per training step in the backward pass (the program's span
``backward``), as a mean over the last unprofiled steps
(``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "step",
                      lambda u: spans.span_ms(u, ("backward",)))
