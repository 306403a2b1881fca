"""ctypes binding for the native IQ stream engine (``native/iqstream.cc``).

Port of ``liquid_usrp_tpu/io/native.py``, loading the same library
(``native/libiqstream.so``, built by ``make -C native`` on first use when a
toolchain is there): CF32/SC16 file I/O, a double-buffered background block
reader and writer, and one-pass converters to the device-ingest planes of
``ops/iqfmt.py``.  Without the library every function here takes its NumPy
path, except :class:`NativeReader` and :class:`NativeWriter`, which
raise.

The converters return host tensors: bfloat16 planes are built from the
engine's uint16 bit patterns viewed as ``torch.bfloat16`` (no
``ml_dtypes``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

__all__ = ["available", "read_file", "write_file", "NativeReader",
           "NativeWriter", "FORMAT_CF32", "FORMAT_SC16", "cf32_to_bf16_planes",
           "cf32_to_sc8_planes"]

FORMAT_CF32 = 0
FORMAT_SC16 = 1

_SIZE_ERR = (1 << 64) - 1     # the C ABI's (size_t)-1 I/O-error signal

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libiqstream.so")
_lib = None
_load_failed_mtime = None    # source mtime at the last failed build


def _load():
    global _lib, _load_failed_mtime
    if _lib is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, "iqstream.cc")
    if _load_failed_mtime is not None:
        # a failed build is cached until the source changes
        try:
            if os.path.getmtime(src) <= _load_failed_mtime:
                return None
        except OSError:
            return None
    stale = (not os.path.exists(_LIB_PATH) or
             (os.path.exists(src) and
              os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale:
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            if not os.path.exists(_LIB_PATH):
                _load_failed_mtime = os.path.getmtime(src) \
                    if os.path.exists(src) else 0.0
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _load_failed_mtime = os.path.getmtime(src) \
            if os.path.exists(src) else 0.0
        return None
    lib.iq_reader_open.restype = ctypes.c_void_p
    lib.iq_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_size_t]
    lib.iq_reader_next.restype = ctypes.c_size_t
    lib.iq_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.iq_reader_close.restype = None
    lib.iq_reader_close.argtypes = [ctypes.c_void_p]
    lib.iq_file_size_samples.restype = ctypes.c_size_t
    lib.iq_file_size_samples.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.iq_read_file.restype = ctypes.c_size_t
    lib.iq_read_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_size_t]
    lib.iq_write_file.restype = ctypes.c_int
    lib.iq_write_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_size_t]
    lib.iq_writer_open.restype = ctypes.c_void_p
    lib.iq_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_size_t]
    lib.iq_writer_push.restype = ctypes.c_int
    lib.iq_writer_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t]
    lib.iq_writer_close.restype = ctypes.c_int
    lib.iq_writer_close.argtypes = [ctypes.c_void_p]
    lib.iq_cf32_to_bf16_planes.restype = None
    lib.iq_cf32_to_bf16_planes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_size_t]
    lib.iq_cf32_to_sc8_planes.restype = None
    lib.iq_cf32_to_sc8_planes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_size_t]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_file(path: str, fmt: int = FORMAT_CF32) -> np.ndarray:
    if not os.path.isfile(path):
        # the C engine reports an fopen failure as size 0
        raise FileNotFoundError(path)
    lib = _load()
    if lib is None:
        if fmt == FORMAT_SC16:
            raw = np.fromfile(path, dtype=np.int16).astype(np.float32)
            raw /= 32767.0
            return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
        from .streams import read_iq
        return read_iq(path)
    n = lib.iq_file_size_samples(path.encode(), fmt)
    if n == _SIZE_ERR:
        raise IOError(f"cannot determine size of {path} (non-seekable?)")
    buf = np.empty(2 * n, dtype=np.float32)
    got = lib.iq_read_file(path.encode(), fmt,
                           buf.ctypes.data_as(ctypes.c_void_p), n)
    if got == _SIZE_ERR:
        raise IOError(f"read error in {path}")
    buf = buf[: 2 * got]
    return (buf[0::2] + 1j * buf[1::2]).astype(np.complex64)


def write_file(path: str, samples: np.ndarray,
               fmt: int = FORMAT_CF32) -> None:
    lib = _load()
    samples = np.asarray(samples, dtype=np.complex64)
    if lib is None:
        if fmt != FORMAT_CF32:
            raise RuntimeError("SC16 output requires the native engine")
        from .streams import write_iq
        write_iq(path, samples)
        return
    inter = _interleave(samples)
    rc = lib.iq_write_file(path.encode(), fmt,
                           inter.ctypes.data_as(ctypes.c_void_p),
                           samples.size)
    if rc != 0:
        raise IOError(f"iq_write_file failed for {path}")


def _interleave(samples: np.ndarray) -> np.ndarray:
    """Complex64 ``[n]`` -> float32 ``[2n]`` as I, Q, I, Q, ..."""
    inter = np.empty(2 * samples.size, dtype=np.float32)
    inter[0::2] = samples.real
    inter[1::2] = samples.imag
    return inter


def cf32_to_bf16_planes(samples: np.ndarray) -> torch.Tensor:
    """Complex64 stream -> ``[2, n]`` bfloat16 I/Q planes (a host tensor),
    deinterleaved and rounded to nearest even in one native pass (torch's
    rounding otherwise)."""
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    lib = _load()
    if lib is None:
        return torch.from_numpy(np.stack([samples.real, samples.imag])) \
            .to(torch.bfloat16)
    out = np.empty((2, samples.size), dtype=np.uint16)
    lib.iq_cf32_to_bf16_planes(samples.ctypes.data_as(ctypes.c_void_p),
                               out.ctypes.data_as(ctypes.c_void_p),
                               samples.size)
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def cf32_to_sc8_planes(samples: np.ndarray) -> torch.Tensor:
    """Complex64 stream -> ``[2, n]`` int8 SC8 wire-code planes (a host
    tensor; ``ops/iqfmt.py`` convention: +-127 <-> +-1.0 full scale, the
    caller is the AGC, rounding to nearest even, clipping)."""
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    lib = _load()
    if lib is None:
        return torch.from_numpy(np.clip(np.round(np.stack(
            [samples.real, samples.imag]) * 127.0), -127, 127)
            .astype(np.int8))
    out = np.empty((2, samples.size), dtype=np.int8)
    lib.iq_cf32_to_sc8_planes(samples.ctypes.data_as(ctypes.c_void_p),
                              out.ctypes.data_as(ctypes.c_void_p),
                              samples.size)
    return torch.from_numpy(out)


class NativeReader:
    """Double-buffered block reader (background prefetch thread in C++)."""

    def __init__(self, path: str, block_samples: int,
                 fmt: int = FORMAT_CF32):
        lib = _load()
        if lib is None:
            raise RuntimeError("native iqstream library unavailable")
        self._lib = lib
        self._h = lib.iq_reader_open(path.encode(), fmt, block_samples)
        if not self._h:
            raise IOError(f"cannot open {path}")
        self._block = block_samples
        self._buf = np.empty(2 * block_samples, dtype=np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            raise StopIteration
        n = self._lib.iq_reader_next(
            self._h, self._buf.ctypes.data_as(ctypes.c_void_p))
        if n == _SIZE_ERR:
            self.close()
            raise IOError("read error mid-stream (not end-of-file)")
        if n == 0:
            self.close()
            raise StopIteration
        # interleaved float32 I, Q is complex64's layout: one copy
        out = self._buf[: 2 * n].view(np.complex64).copy()
        if n < self._block:
            self.close()
        return out

    def close(self):
        if getattr(self, "_h", None) is not None:   # None: open failed
            self._lib.iq_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # an abandoned reader would leak the C++ fill thread, both block
        # buffers and the FILE handle
        self.close()


class NativeWriter:
    """Background-thread block writer (the TX-side mirror of
    :class:`NativeReader`): ``push`` enqueues a block and returns; a C++
    worker thread drains the bounded queue (``depth`` blocks, back-pressure
    when full) to disk."""

    def __init__(self, path: str, fmt: int = FORMAT_CF32, depth: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native iqstream library unavailable")
        self._lib = lib
        self._h = lib.iq_writer_open(path.encode(), fmt, depth)
        if not self._h:
            raise IOError(f"cannot open {path} for writing")

    def push(self, samples: np.ndarray) -> None:
        if self._h is None:
            raise RuntimeError("writer closed")
        samples = np.asarray(samples, dtype=np.complex64)
        inter = _interleave(samples)
        rc = self._lib.iq_writer_push(
            self._h, inter.ctypes.data_as(ctypes.c_void_p), samples.size)
        if rc != 0:
            raise IOError("iq_writer_push failed")

    def close(self) -> None:
        if self._h is not None:
            rc = self._lib.iq_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("write error on close")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
