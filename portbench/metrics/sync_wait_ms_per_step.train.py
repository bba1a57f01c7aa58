"""Host ms per training step spent in the synchronisations that
``host_syncs_per_step.train`` counts, waiting on the device: a step's mean
plus its share of its epoch's (``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.per_step(records, spans.sync_ms)
