"""ctypes bindings for the port's native host I/O (``csrc/pngio.cpp``).

Counterpart of ``panodepth/utils/nativeio.py``: a PNG decoder and encoder
and a threaded batch prefetcher, in host C++ built with
``g++`` at first use (``kernels/_build.py``, linked against zlib) and
called through :class:`ctypes.CDLL`, which releases the GIL for each call,
so decoding threads run side by side.  A failed build raises; nothing falls
back to the Python codec (``io.read_png_py`` / ``io.png_bytes_py``, the
plain twins the tests hold this library against).

Decodes return the file's integers, uint8 or uint16 of shape (H, W) or
(H, W, C), as ``io.read_png`` always has.  PFMs are read by ``io.load_pfm``.
A refused file raises :class:`ValueError` naming it (the twin's messages),
a file that cannot be read :class:`OSError` (:class:`FileNotFoundError`
when missing), an allocation that fails :class:`MemoryError`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import weakref
from typing import List, Optional, Union

import numpy as np

from ..kernels import _build

# pd_image's statuses and kinds (csrc/pngio.cpp)
_OK, _OS, _FORMAT, _NOMEM, _TAKEN, _RANGE = range(6)
_DTYPES = {1: np.uint8, 2: np.uint16}
_RAW = 4


class _Image(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("nbytes", ctypes.c_size_t),
                ("height", ctypes.c_int64), ("width", ctypes.c_int64),
                ("channels", ctypes.c_int32), ("kind", ctypes.c_int32),
                ("status", ctypes.c_int32), ("err_no", ctypes.c_int32),
                ("msg", ctypes.c_char * 256)]


_IMP = ctypes.POINTER(_Image)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The library (built at first use) with its signatures set."""
    lib = _build.load("pngio")
    lib.pd_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_size_t, _IMP]
    lib.pd_png_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, _IMP]
    lib.pd_prefetch_start.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int]
    lib.pd_prefetch_start.restype = ctypes.c_void_p
    lib.pd_prefetch_take.argtypes = [ctypes.c_void_p, ctypes.c_int, _IMP]
    lib.pd_prefetch_free.argtypes = [ctypes.c_void_p]
    lib.pd_prefetch_free.restype = None
    lib.pd_free.argtypes = [ctypes.c_void_p]
    lib.pd_free.restype = None
    for name in ("pd_zlib_version", "pd_zlib_header"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    return lib


def zlib_info() -> dict:
    """The zlib the library runs with (``zlibVersion()``) and the version
    of the ``zlib.h`` it was built against."""
    lib = _lib()
    return dict(version=lib.pd_zlib_version().decode(),
                header=lib.pd_zlib_header().decode())


def _raise(im: _Image, name: str):
    msg = im.msg.decode(errors="replace")
    if im.status == _OS:
        raise OSError(im.err_no, os.strerror(im.err_no), name)
    if im.status == _NOMEM:
        raise MemoryError(f"{name}: {msg}")
    raise ValueError(f"{name}: {msg}")


def _adopt(im: _Image) -> np.ndarray:
    """The result's buffer as an array that owns it (freed with the array);
    pixels reshaped to (H, W) or (H, W, C)."""
    lib = _lib()
    dtype = _DTYPES[im.kind]
    h, w, c = im.height, im.width, im.channels
    shape = (h, w) if c == 1 else (h, w, c)
    if not im.nbytes:
        lib.pd_free(im.data)
        return np.zeros(shape, dtype)
    buf = (ctypes.c_uint8 * im.nbytes).from_address(im.data)
    weakref.finalize(buf, lib.pd_free, im.data)
    return np.frombuffer(buf, dtype).reshape(shape)


def _bytes(im: _Image) -> bytes:
    try:
        return ctypes.string_at(im.data, im.nbytes)
    finally:
        _lib().pd_free(im.data)


def decode_png(src: Union[str, os.PathLike, bytes],
               name: Optional[str] = None) -> np.ndarray:
    """A PNG file (a path), or a PNG's bytes, decoded to uint8 or uint16,
    (H, W) or (H, W, C); errors name ``name`` (else the path)."""
    im = _Image()
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
        _lib().pd_png_decode(None, data, len(data), ctypes.byref(im))
        name = name or "<PNG data>"
    else:
        path = os.fspath(src)
        _lib().pd_png_decode(os.fsencode(path), None, 0, ctypes.byref(im))
        name = name or path
    if im.status != _OK:
        _raise(im, name)
    return _adopt(im)


def read_image_f32(path: str) -> np.ndarray:
    """PNG (8/16-bit, any colour type the decoder takes) -> float32 0~1
    through ``io._to01``; PFM -> its raw floats (``io.load_pfm``)."""
    from .. import io as pio

    if path.lower().endswith(".pfm"):
        return pio.load_pfm(path)
    return pio._to01(decode_png(path))


def _encode(arr: np.ndarray, level: int, path: Optional[str]) -> _Image:
    a = np.asarray(arr)
    if a.dtype.kind == "u" and a.dtype.itemsize in (1, 2):  # host order
        a = np.ascontiguousarray(a, (np.uint8, np.uint16)[a.itemsize - 1])
    if a.dtype not in (np.uint8, np.uint16) or not (
            a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"a PNG is written from uint8 or uint16 (H, W) or "
                         f"(H, W, 3), got {a.dtype} {a.shape}")
    im = _Image()
    _lib().pd_png_encode(
        a.ctypes.data, a.shape[0], a.shape[1], 1 if a.ndim == 2 else 3,
        8 * a.itemsize, int(level),
        None if path is None else os.fsencode(path), ctypes.byref(im))
    if im.status != _OK:
        _raise(im, path or "PNG encode")
    return im


def encode_png(arr: np.ndarray, level: int) -> bytes:
    """A uint8 or uint16 gray (H, W) or RGB (H, W, 3) array as a PNG's
    bytes: every row Up-filtered, deflate ``level`` (always lossless)."""
    return _bytes(_encode(arr, level, None))


def write_png(path: str, arr: np.ndarray, level: int) -> None:
    """:func:`encode_png` written to ``path``."""
    _encode(arr, level, path)


def write_png16(path: str, data: np.ndarray, level: int = 1) -> None:
    """A lossless 16-bit gray PNG of a 2-D array, cast to uint16
    (Up-filtered rows, deflate ``level``)."""
    arr = np.ascontiguousarray(data, np.uint16)
    if arr.ndim != 2:
        raise ValueError(f"{path}: a 16-bit PNG is written from a 2-D "
                         f"array, got {arr.shape}")
    write_png(path, arr, level)


def _ncpu() -> int:
    """CPUs this process may run on (its affinity; ``os.cpu_count`` reports
    the whole host and over-engages the prefetcher in a container).  On
    one CPU the prefetcher's one worker ties decoding one file after
    another (``scripts/torch_host_loads.py --cpus 1``, PERF.md §6), so
    nothing else chooses between them."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # pragma: no cover - not Linux
        return os.cpu_count() or 1


class BatchPrefetcher:
    """Decodes ``paths`` on ``threads`` worker threads (at most the CPUs
    of this process's affinity) outside the GIL; ``get(i)`` waits for file
    i and returns what ``io.read_image`` returns for it, or raises its
    error.  Each item is taken once.  ``close()`` (or leaving a ``with``
    block) stops the workers from starting new files, joins them and frees
    what was not taken."""

    def __init__(self, paths: List[str], threads: int = 8):
        self._paths = [os.fspath(p) for p in paths]
        n = len(self._paths)
        self.threads = max(1, min(int(threads), _ncpu(), n))
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in self._paths])
        self._lib = _lib()
        self._handle = self._lib.pd_prefetch_start(arr, n, self.threads)
        if not self._handle:
            raise RuntimeError("the prefetcher could not start its threads")

    def get(self, index: int) -> np.ndarray:
        if not self._handle:
            raise ValueError("the prefetcher is closed")
        if not 0 <= index < len(self._paths):
            raise IndexError(f"item {index} of {len(self._paths)}")
        im = _Image()
        self._lib.pd_prefetch_take(self._handle, index, ctypes.byref(im))
        name = self._paths[index]
        if im.status == _TAKEN:
            raise ValueError(f"{name}: item {index} was taken already")
        if im.status != _OK:
            _raise(im, name)
        if im.kind == _RAW:  # not a PNG: the other codecs, as io does
            from .. import io as pio

            return pio.decode_image(_bytes(im), name)
        return _adopt(im)

    def __len__(self) -> int:
        return len(self._paths)

    def close(self) -> None:
        if self._handle:
            self._lib.pd_prefetch_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
