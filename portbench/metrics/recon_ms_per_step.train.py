"""Host ms per training step in the program's span ``recon`` (the recon
loss's forward, its blocks dispatched), as a mean over the last unprofiled
steps (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "step",
                      lambda u: spans.span_ms(u, ("recon",)))
