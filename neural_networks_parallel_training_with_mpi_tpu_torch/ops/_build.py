"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``) and loaded with
``ctypes``.  The library's file name carries a hash of the source, of
the shared headers ``csrc/*.cuh`` it may include, and of the flags, so
an edited source or header rebuilds and an unchanged one loads the
existing library.  A missing ``nvcc`` or a failed build raises: there is
no fallback to the plain PyTorch version on the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (library, build record); one load per process
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return path


def load(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<name>.cu``.  Returns the
    library and a record ``{"built": bool, "seconds": float, "log":
    ptxas output, "path": str}``."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    record = {"built": False, "seconds": 0.0, "log": "",
              "path": str(lib_path)}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: a reader never sees half a .so
        record["built"] = True
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, record)
    return lib, record
