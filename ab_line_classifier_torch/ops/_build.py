"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the root of the
checkout on first use, then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited kernel is rebuilt and a stale library is
never loaded. nvcc's output, with ptxas's registers and spills of every
kernel, is kept beside the library (:func:`build_log`). Nothing is
compiled when a module is imported: this happens inside the first call
that launches a kernel (or in :func:`build`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile kernel ``name`` unless its library exists. Returns the
    library path; raises with nvcc's output if the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    return out


def build_log(name: str) -> str:
    """nvcc's output of the last build of kernel ``name``."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
