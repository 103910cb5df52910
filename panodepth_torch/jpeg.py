"""Baseline JPEG decode and encode through the port's own codec.

``csrc/jpeg.cpp`` is host C++ built with ``g++`` at first use
(``kernels/_build.py``) and bound here with ``ctypes``.  It decodes the
pixels libjpeg(-turbo) gives by default, the reader behind Pillow, and
writes the file libjpeg writes for Pillow's ``save(quality=q)``; what it
does not take (progressive, arithmetic-coded, 12-bit, lossless, CMYK, ...)
raises :class:`ValueError` naming the file and the reason.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .kernels import _build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_ERRLEN = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    """The codec's library (built at first use) with its signatures set."""
    lib = _build.load("jpeg")
    lib.pd_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t]
    lib.pd_jpeg_decode.restype = ctypes.c_int
    lib.pd_jpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.pd_jpeg_encode.restype = ctypes.c_int
    lib.pd_jpeg_free.argtypes = [ctypes.c_void_p]
    lib.pd_jpeg_free.restype = None
    return lib


def decode(data: bytes, name: str = "") -> np.ndarray:
    """A JPEG file's bytes -> uint8 (H, W) for gray or (H, W, 3) for RGB.

    Raises ValueError, naming ``name`` and the reason, on a file the codec
    does not take or a corrupt one."""
    lib = _lib()
    out = _U8P()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.pd_jpeg_decode(bytes(data), len(data), ctypes.byref(out),
                            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                            err, _ERRLEN)
    if rc != 0:
        raise ValueError(f"{name or '<JPEG data>'}: {err.value.decode()}")
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(out, (n,)).copy()
    finally:
        lib.pd_jpeg_free(out)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    return arr.reshape(shape)


def encode(arr: np.ndarray, quality: int = 95) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> the bytes of a baseline JPEG
    (4:2:0 for RGB), as Pillow's ``save(quality=quality)`` writes them."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise TypeError(f"encode takes uint8 pixels, got {a.dtype}")
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"encode takes (H, W) or (H, W, 3), got {a.shape}")
    a = np.ascontiguousarray(a)
    lib = _lib()
    out = _U8P()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.pd_jpeg_encode(a.ctypes.data, a.shape[0], a.shape[1],
                            1 if a.ndim == 2 else 3, int(quality),
                            ctypes.byref(out), ctypes.byref(size), err,
                            _ERRLEN)
    if rc != 0:
        raise ValueError(f"JPEG encode: {err.value.decode()}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.pd_jpeg_free(out)
