"""Host synchronisations per training step that the program counts
(``telemetry.sync``: the sampler's round tests, the epoch's index copies
and its one fetch): a step's mean plus its share of its epoch's
(``core/spans.py``)."""

from portbench.core import spans


def read(records):
    return spans.per_step(records, spans.syncs)
