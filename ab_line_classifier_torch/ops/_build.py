"""Build and load the port's native code.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the root of the
checkout on first use, then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited kernel is rebuilt and a stale library is
never loaded. nvcc's output, with ptxas's registers and spills of every
kernel, is kept beside the library (:func:`build_log`). Nothing is
compiled when a module is imported: this happens inside the first call
that launches a kernel (or in :func:`build`).

Host libraries (``csrc/<name>.cc``: the JPEG loader) are built the same
way by ``g++`` into ``build/native/`` (:func:`build_host`).
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
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# No -march=native: the hash does not cover the host's CPU, and a build
# directory may be copied to another machine.
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
# name of a host source -> (library name, libraries it links)
HOST_LIBS = {"loader": ("ablcloader", ["-ljpeg", "-lpthread"])}

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def _hashed_path(src: str, flags: List[str], out_dir: str,
                 lib: str) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(out_dir, f"lib{lib}-{h.hexdigest()[:12]}.so")


def library_path(name: str) -> str:
    return _hashed_path(os.path.join(CSRC_DIR, name + ".cu"), NVCC_FLAGS,
                        BUILD_DIR, name)


def _compile(cmd: List[str], out: str, what: str) -> str:
    """Run ``cmd`` (which writes ``<out>.tmp<pid>``) unless ``out`` exists;
    keep its output beside the library. Raises with the output on
    failure."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} build failed: {cmd[0]} exited "
                           f"{proc.returncode}\n{proc.stdout}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    return out


def build(name: str) -> str:
    """Compile kernel ``name`` unless its library exists. Returns the
    library path; raises with nvcc's output if the build fails."""
    return _compile([_nvcc(), *NVCC_FLAGS,
                     os.path.join(CSRC_DIR, name + ".cu")],
                    library_path(name), f"kernel {name}")


def host_library_path(name: str) -> str:
    return _hashed_path(os.path.join(CSRC_DIR, name + ".cc"),
                        GXX_FLAGS + HOST_LIBS[name][1], NATIVE_DIR,
                        HOST_LIBS[name][0])


def build_host(name: str) -> str:
    """Compile host library ``name`` (``csrc/<name>.cc``) with g++ unless
    its library exists. Returns the library path; raises with the
    compiler's output if the build fails (``OSError`` without g++)."""
    return _compile(["g++", *GXX_FLAGS, os.path.join(CSRC_DIR, name + ".cc"),
                     *HOST_LIBS[name][1]],
                    host_library_path(name), f"host library {name}")


def has_header(header: str) -> bool:
    """Whether ``#include <header>`` resolves on g++'s include path."""
    proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                          input=f"#include <{header}>\n", text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc.returncode == 0


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
