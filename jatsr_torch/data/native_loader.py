"""ctypes binding of the C++ latent batch engine (``native/``).

``native/latentloader.cpp`` memory-maps every ``*.npy`` latent shard once and
fills a batch of crops (fp16 -> fp32, short songs tiled) on a pool of
threads, straight into the caller's buffers.  Its crops are the numpy
path's (``data/dataset.py:_crop_or_loop``) bit for bit.

The library is built on first use with ``make -C native`` (g++) into
``native/build/``; a failed build is remembered and reported by
:func:`build_error`, and ``BatchLoader(native=True)`` then raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "liblatentloader.so"
_lib = None
_build_error: Optional[str] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _build() -> None:
    """``make -C native`` under a lock, so that two processes never write
    the library at once."""
    (_NATIVE_DIR / "build").mkdir(exist_ok=True)
    with open(_NATIVE_DIR / "build" / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, text=True)


def _load_lib():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.ll_open.restype = ctypes.c_void_p
        lib.ll_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int64]
        lib.ll_frames.restype = ctypes.c_int64
        lib.ll_frames.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ll_channels.restype = ctypes.c_int64
        lib.ll_channels.argtypes = [ctypes.c_void_p]
        lib.ll_fill_batch.restype = ctypes.c_int
        lib.ll_fill_batch.argtypes = [ctypes.c_void_p, _I64P, _I64P,
                                      ctypes.c_int64, ctypes.c_int64, _F32P,
                                      _F32P, ctypes.c_int]
        lib.ll_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or ""
        _build_error = f"{e} {detail}".strip()
    return _lib


def is_available() -> bool:
    return _load_lib() is not None


def build_error() -> Optional[str]:
    """None once the library is loaded; else why it could not be."""
    _load_lib()
    return _build_error


class NativeLatentStore:
    """Memory-mapped latent shards and threaded batch assembly."""

    def __init__(self, hr_paths: List[str], n_threads: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self.n_threads = n_threads
        lr_paths = [p.replace(".hr.npy", ".lr.npy") for p in hr_paths]
        n = len(hr_paths)
        hr_arr = (ctypes.c_char_p * n)(*[p.encode() for p in hr_paths])
        lr_arr = (ctypes.c_char_p * n)(*[p.encode() for p in lr_paths])
        self._h = lib.ll_open(hr_arr, lr_arr, n)
        if not self._h:
            raise RuntimeError("ll_open failed (a shard that is not a 2-D "
                               "fp16 .npy?)")
        self.n_files = n
        self.channels = int(lib.ll_channels(self._h))
        self.frames = [int(lib.ll_frames(self._h, i)) for i in range(n)]

    def fill_batch(self, file_idx: np.ndarray, starts: np.ndarray,
                   target: int):
        """``(file_idx [B], starts [B])`` -> ``(hr, lr)`` float32
        ``[B, target, C]``."""
        B = len(file_idx)
        hr = np.empty((B, target, self.channels), np.float32)
        lr = np.empty((B, target, self.channels), np.float32)
        idx = np.ascontiguousarray(file_idx, np.int64)
        st = np.ascontiguousarray(starts, np.int64)
        rc = self._lib.ll_fill_batch(
            self._h, idx.ctypes.data_as(_I64P), st.ctypes.data_as(_I64P),
            B, target, hr.ctypes.data_as(_F32P), lr.ctypes.data_as(_F32P),
            self.n_threads)
        if rc != 0:
            raise RuntimeError(f"ll_fill_batch error code {rc}")
        return hr, lr

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ll_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
