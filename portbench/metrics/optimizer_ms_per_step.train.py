"""Host ms per training step in the optimizer (the program's span
``optimizer``: zero_grad, the gradient sum under a mesh, AdamW's step), as
a mean over the last unprofiled steps (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "step",
                      lambda u: spans.span_ms(u, ("optimizer",)))
