"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> a ``torch.device``; raises for CUDA when no GPU is present.

    Entry points default to ``"cuda"``.  They never fall back to the CPU on
    their own: the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def to_device(host, device) -> torch.Tensor:
    """A small host array or tensor -> ``device`` without waiting for the
    device: a blocking copy from pageable host memory synchronises the
    stream first; a non-blocking one stages the bytes and returns."""
    return torch.as_tensor(host).to(device, non_blocking=True)
