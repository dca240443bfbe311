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

Every kernel wrapper launches through a :class:`Kernel`: its library loaded
and typed once, each launch on the tensors' device and current stream, a
failed launch raised with the kernel's own error string, a launch that
succeeded counted in ``ops/launches.py``. :func:`check_nhwc` is the input
check the fused kernels (``conv_epilogue_cuda``, ``bn_act_cuda``) share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from ab_line_classifier_torch.ops import launches

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


#: The dtypes the kernels compute in (B2 and the fused kernels).
DTYPES = (torch.float32, torch.bfloat16)
#: Channels that fill whole 16-byte vectors in each of :data:`DTYPES`
#: (bfloat16's 8): ``graph.GraphModule`` routes a layer to a fused kernel
#: only at a multiple of it, fixed before any dtype is known.
VECTOR_CHANNELS = 8


def check_nhwc(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is what a fused kernel reads and writes: a
    float32 or bfloat16 ``[B, C, H, W]`` view of NHWC memory
    (``channels_last``), 16-byte aligned, its channels whole 16-byte
    vectors."""
    if x.ndim != 4 or x.dtype not in DTYPES:
        raise ValueError(f"expected a float32 or bfloat16 [B, C, H, W] "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] * x.element_size() % 16:
        raise ValueError(f"{x.shape[1]} channels of {x.dtype}: the kernel "
                         f"takes whole 16-byte vectors")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels_last (NHWC memory)")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


class Kernel:
    """Kernel ``name``'s library (``csrc/<name>.cu``) and its launches,
    counted under ``key`` in ``ops/launches.py``. ``functions`` gives each
    C function's argument types; every one returns an ``int``, a launch
    function's error code (0: launched) with the stream its last argument,
    and a query's count. A launch reads nothing back to the host, so a
    CUDA graph's capture records it."""

    def __init__(self, name: str, key: str, **functions: List):
        self.name, self.key, self.functions = name, key, functions
        #: The typed library: loaded by :meth:`library` on first use; a
        #: check may put another build of the source here (:meth:`typed`).
        self.lib: Optional[ctypes.CDLL] = None
        self._fits: Dict[tuple, Tuple[int, int]] = {}

    def typed(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """``lib``, a build of the kernel's source, its functions typed."""
        for fn, argtypes in self.functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ablc_error_string.argtypes = [ctypes.c_int]
        lib.ablc_error_string.restype = ctypes.c_char_p
        return lib

    def library(self) -> ctypes.CDLL:
        """The typed library, built and loaded on first use."""
        if self.lib is None:
            self.lib = self.typed(load_library(self.name))
        return self.lib

    def launch(self, fn: str, device: torch.device, *args,
               count: bool = True) -> None:
        """``fn(*args, stream)`` on ``device``'s current stream; raises
        with the kernel's error string where the launch fails, and counts
        one launch where it succeeds (unless not ``count``)."""
        lib = self.lib or self.library()
        stream = torch.cuda.current_stream(device).cuda_stream
        if device.index == torch.cuda.current_device():
            rc = getattr(lib, fn)(*args, stream)
        else:
            with torch.cuda.device(device):
                rc = getattr(lib, fn)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               + lib.ablc_error_string(rc).decode())
        if count:
            launches.add(self.key)

    def query(self, fn: str, device: torch.device, *args) -> int:
        """``fn(*args)`` with ``device`` current: the runtime's count of
        the blocks of a variant of the kernel that fit on one SM."""
        with torch.cuda.device(device):
            return getattr(self.library(), fn)(*args)

    def occupancy(self, fn: str, device: torch.device,
                  *args) -> Tuple[int, int]:
        """``(SMs, blocks that fit on one at once)`` of ``device`` for the
        variant ``args`` selects (:meth:`query`), cached; raises where no
        block fits."""
        key = (fn, device, args)
        fit = self._fits.get(key)
        if fit is None:
            n = self.query(fn, device, *args)
            if n < 1:
                raise RuntimeError(f"no block of the {self.name} kernel "
                                   f"{args} fits on an SM")
            fit = self._fits[key] = (torch.cuda.get_device_properties(
                device).multi_processor_count, n)
        return fit
