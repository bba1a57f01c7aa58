"""Host ms per training step in the model's forward: the program's spans
``encode`` (the node-table encode), ``forward`` (the token stream, recon
included) and ``loss`` (the BCE and the alpha/beta sum), as a mean over the
last unprofiled steps (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.mean(records, "step", lambda u: spans.span_ms(
        u, ("encode", "forward", "loss")))
