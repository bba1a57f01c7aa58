"""matcha_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of matcha_tpu.

The package mirrors ``matcha_tpu``'s layout and names module for module, so
each part can be held against its JAX counterpart.  It imports ``torch`` and
never ``jax`` or anything of ``matcha_tpu``.

Entry points take an explicit ``device`` and default to ``"cuda"``; without a
GPU they raise unless the caller passes ``device="cpu"``, which runs the plain
PyTorch versions of the kernels.
"""
