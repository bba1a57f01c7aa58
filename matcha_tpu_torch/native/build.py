"""Build the port's host C++ helpers with g++ and load them with ctypes.

Each helper is one ``native/<name>.cpp`` with a plain C interface (the JAX
package's sources, copied), compiled at first use into
``matcha_tpu_torch/_build/lib<name>-<hash>.so``, as ``kernels/build.py``
builds the CUDA sources: the hash covers the source and the flags, so an
edited source is rebuilt, and nothing is written beside the sources.  A
helper that cannot be built or loaded is reported as missing (None), and its
caller takes its numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

from matcha_tpu_torch.kernels.build import BUILD_DIR

NATIVE = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def library_path(name: str, flags: Sequence[str]) -> Path:
    h = hashlib.sha256((NATIVE / f"{name}.cpp").read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_host_library(name: str, flag_sets: Sequence[Sequence[str]]
                      ) -> Optional[ctypes.CDLL]:
    """Build ``native/<name>.cpp`` with the first of ``flag_sets`` that
    compiles (each added to GXX_FLAGS; a later set is the retry without,
    say, OpenMP), unless it is built already, and load it.  -> None when no
    set builds and loads."""
    for extra in flag_sets:
        flags = (*GXX_FLAGS, *extra)
        target = library_path(name, flags)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *flags, "-o", str(tmp),
                                str(NATIVE / f"{name}.cpp")], check=True,
                               capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, target)        # atomic: concurrent builds agree
        try:
            return ctypes.CDLL(str(target))
        except OSError:
            continue
    return None
