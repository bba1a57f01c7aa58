"""Device ms per training step of the communication kernels (names
``nccl...``) in rank 0's profiled stretch of a mesh cell
(``drivers/train_epochs_mesh.py``)."""


def read(records):
    if (records.get("kind") != "train" or not records.get("units")
            or not records.get("busy_s") or "collective_s" not in records):
        return None
    return 1e3 * records["collective_s"] / records["units"]
