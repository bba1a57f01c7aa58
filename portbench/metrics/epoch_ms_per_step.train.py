"""Host ms per training step of the epoch's own work, outside its steps
(the index draw and copies, the gathers, the aux stack, the one fetch and
the per-size metrics): an epoch unit's time less its steps', over its
steps, as a median over the unprofiled epochs (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.epoch_median(records, lambda u: 1e3 * u.own_s())
