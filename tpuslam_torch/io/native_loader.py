"""ctypes wrapper of the native C++ image decoder and prefetch ring.

Counterpart of tpuslam/io/native_loader.py.  csrc/loader.cpp (a verbatim
copy of tpuslam/native/loader.cpp) decodes 8-bit PNGs of colour types
0/2/4/6 with all five row filters on zlib, and binary PGM (P5), to gray
(its own integer luma for RGB: (299 R + 587 G + 114 B + 500) / 1000); its
decoder threads fill a ring of frame banks ahead of the consumer, the
reference's double-banked DDR buffers (FPGA.h:35-53).  ctypes releases the
GIL for the length of every C call, so the Python threads of the run go on
while a frame is decoded or awaited.

The library is built by g++ at first use into
`build/tpuslam_torch/<hash>/libloader.so` beside the package, keyed by a
hash of the source and flags, through a temporary file and an atomic
rename, so that processes building at once do not race.  A failed build
raises with the compiler's output: nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpuslam_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz", "-lpthread"]

_lib = None
_lib_lock = threading.Lock()


class NativeLoaderUnavailable(RuntimeError):
    pass


def lib_path() -> Path:
    """The library of csrc/loader.cpp, keyed by its source and flags."""
    h = hashlib.sha256(SRC.read_bytes() +
                       " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_ROOT / h / "libloader.so"


def build() -> Path:
    """Compile csrc/loader.cpp unless its library exists; returns the
    library's path.  Raises NativeLoaderUnavailable with the compiler's
    output if g++ fails or is missing."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++"] + GXX_FLAGS + [str(SRC), "-o", str(tmp)] + LIBS
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeLoaderUnavailable(
            f"g++ failed for csrc/loader.cpp:\n{detail}") from e
    os.replace(tmp, out)
    return out


def get_lib():
    """The typed library, built and loaded on first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.tsl_open.restype = ctypes.c_void_p
        lib.tsl_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_int]
        lib.tsl_count.restype = ctypes.c_int
        lib.tsl_count.argtypes = [ctypes.c_void_p]
        lib.tsl_next.restype = ctypes.c_int
        lib.tsl_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.tsl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tsl_close.argtypes = [ctypes.c_void_p]
        lib.tsl_decode.restype = ctypes.c_int
        lib.tsl_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def decode_image(path: str, max_pixels: int = 8 << 20) -> np.ndarray:
    """Decode one PNG/PGM to (H, W) uint8 through the native decoder."""
    lib = get_lib()
    buf = np.empty(max_pixels, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    n = lib.tsl_decode(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_pixels, ctypes.byref(w), ctypes.byref(h))
    if n < 0:
        raise IOError(f"native decode failed ({n}): {path}")
    return buf[:n].reshape(h.value, w.value).copy()


class NativeStereoLoader:
    """Iterator over prefetched stereo pairs:

        for idx, left, right in NativeStereoLoader(lpaths, rpaths): ...

    `left`/`right` are zero-copy views into a bank, valid only until the
    next iteration (the bank is released then): copy them out, or upload
    them, before advancing."""

    def __init__(self, left_paths: list[str], right_paths: list[str],
                 n_banks: int = 4, n_threads: int = 2):
        if len(left_paths) != len(right_paths) or not left_paths:
            raise ValueError("left and right paths: equal, non-empty lists")
        self._lib = get_lib()
        self._h = self._lib.tsl_open(
            "\n".join(left_paths).encode(),
            "\n".join(right_paths).encode(), n_banks, n_threads)
        if not self._h:
            raise NativeLoaderUnavailable("tsl_open failed")
        self._n = self._lib.tsl_count(self._h)
        self._pending_bank = -1

    def __len__(self):
        return self._n

    def __iter__(self):
        lib = self._lib
        lp = ctypes.POINTER(ctypes.c_uint8)()
        rp = ctypes.POINTER(ctypes.c_uint8)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        idx = 0
        while True:
            self._release_pending()
            bank = lib.tsl_next(self._h, ctypes.byref(lp),
                                ctypes.byref(rp), ctypes.byref(w),
                                ctypes.byref(h))
            if bank == -1:
                return
            if bank == -2:
                raise IOError(f"native decode failed at frame {idx}")
            left = np.ctypeslib.as_array(lp, shape=(h.value, w.value))
            right = np.ctypeslib.as_array(rp, shape=(h.value, w.value))
            self._pending_bank = bank
            yield idx, left, right
            idx += 1

    def _release_pending(self):
        if self._pending_bank >= 0:
            self._lib.tsl_release(self._h, self._pending_bank)
            self._pending_bank = -1

    def close(self):
        if self._h:
            self._release_pending()
            self._lib.tsl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
