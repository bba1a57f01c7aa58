"""The recon loss's least time (``work/recon.py`` at the float32 peaks, the
decode's precision) over the device time of what was launched inside the
program's ``matcha:recon`` and ``matcha:recon_backward`` ranges on rank 0
in the profiled training steps, in %; read in a mesh cell's records
(``drivers/train_epochs_mesh.py``)."""

from portbench.core import registry
from portbench.core.trace import bound_s


def read(records):
    if records.get("kind") != "train" or not records.get("recon_device_s"):
        return None
    work = registry.load_module("work", "recon").work
    least = sum(bound_s(*work(c), c["dtype"])
                for c in records.get("recon_calls", []))
    return 100.0 * least / records["recon_device_s"] if least else None
