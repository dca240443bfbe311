"""ctypes binding for the native batch JPEG loader (``csrc/loader.cc``;
port of the JAX package's ``data/native.py``).

The library is built by g++ against libjpeg into
``build/native/libablcloader-<hash>.so`` on first use, never at import
(``ops/_build.py::build_host``; the hash covers the source and the flags,
so an edited source is rebuilt). Where g++ or libjpeg is missing the
loader is unavailable: :func:`native_available` says so,
:func:`build_error` says why, and ``FrameDataset`` decodes with PIL.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ab_line_classifier_torch.ops import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

RESIZE_MODE = {"tf": 0, "cv2": 1}
ABI_VERSION = 1


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded native library, built first if needed; None if it is
    unavailable (:func:`build_error` then gives the reason). A failed
    build is not retried in this process."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build.build_host("loader"))
            lib.ablc_decode_jpeg_batch.restype = ctypes.c_int
            lib.ablc_decode_jpeg_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            lib.ablc_loader_version.restype = ctypes.c_int
            lib.ablc_loader_version.argtypes = []
            version = lib.ablc_loader_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"loader ABI version {version}, want "
                                   f"{ABI_VERSION}")
        except (OSError, RuntimeError) as e:  # no g++, no libjpeg, bad .so
            _error = f"{type(e).__name__}: {e}"
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    """Why the native loader is unavailable (the compiler's or the dynamic
    loader's message), or None when it loads. Tries the build first."""
    load_library()
    return _error


def decode_jpeg_batch(paths: Sequence[str], out_hw: Tuple[int, int],
                      resize_mode: str = "tf", n_threads: int = 0,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode and nearest-resize a batch of JPEGs into uint8
    ``[N, H, W, 3]`` (``out`` when given), on ``n_threads`` threads (0: one
    per core).

    Raises ``RuntimeError`` naming failed files (missing or corrupt), as
    the PIL path fails on them."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    n = len(paths)
    h, w = out_hw
    if out is None:
        out = np.empty((n, h, w, 3), np.uint8)
    # A check that raises, not an assert: the loader writes n*h*w*3 bytes
    # through out's data pointer, and `python -O` strips asserts.
    if not (out.flags["C_CONTIGUOUS"] and out.dtype == np.uint8
            and out.shape == (n, h, w, 3)):
        raise ValueError(
            f"out must be C-contiguous uint8 [{n},{h},{w},3]; got "
            f"{out.dtype} {out.shape} contiguous={out.flags['C_CONTIGUOUS']}")
    codes = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.ablc_decode_jpeg_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, RESIZE_MODE[resize_mode],
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if failures:
        bad = [paths[i] for i in np.nonzero(codes)[0][:5]]
        raise RuntimeError(
            f"native loader failed on {failures}/{n} files, e.g. {bad}")
    return out
