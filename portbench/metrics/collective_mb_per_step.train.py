"""MB (1e6 bytes) per training step that rank 0's collectives move, from the
program's counts ``collective_bytes.<op>`` (all-gathers, reduce-scatters and
all-reduces, those autograd runs in the backward included), as a mean over
the last unprofiled steps (``core/spans.py``); nothing where no step
counted any."""

from portbench.core import spans


def read(records):
    got = spans.units(records, "step")
    if got is None:
        return None
    per = [sum(v for k, v in u.counts.items()
               if k.startswith("collective_bytes.")) for u in got]
    return sum(per) / len(per) / 1e6 if any(per) else None
