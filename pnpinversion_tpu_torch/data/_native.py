"""The port's C++ data-path kernels (``csrc/data_ops.cpp``, its own copy of
the JAX package's), bound with ctypes: the RLE mask decode that
``data/pie_bench.py::mask_decode`` takes for masks of 4096 pixels and more,
and the bilinear uint8 resize (not wired in, as in the JAX package; the
library's nearest resize is bound but, as there, has no wrapper).

The library is built with the host's g++ at first use (``ops/build.py``).
Unlike the JAX package's ``data/_native.py``, a failed build raises: nothing
falls back to numpy without a word. ``available`` only reports.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from pnpinversion_tpu_torch.ops import build

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load_host("data_ops")
    lib.rle_decode.argtypes = [_I64P, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                               ctypes.c_int64]
    lib.resize_bilinear_u8.argtypes = ([_U8P] + [ctypes.c_int64] * 3 + [_U8P]
                                       + [ctypes.c_int64] * 2)
    lib.resize_nearest_u8.argtypes = lib.resize_bilinear_u8.argtypes
    for fn in (lib.rle_decode, lib.resize_bilinear_u8, lib.resize_nearest_u8):
        fn.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def rle_decode(enc: np.ndarray, length: int) -> np.ndarray:
    """[start, len] pairs (n, 2) -> a flat {0, 1} f64 mask of ``length``."""
    enc = np.ascontiguousarray(enc, dtype=np.int64).reshape(-1, 2)
    out = np.empty((length,), dtype=np.float64)
    _lib().rle_decode(enc.ctypes.data_as(_I64P), enc.shape[0],
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), length)
    return out


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """HWC uint8 bilinear resize (half-pixel centres, rounded half up)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), dtype=np.uint8)
    _lib().resize_bilinear_u8(img.ctypes.data_as(_U8P), h, w, c, out.ctypes.data_as(_U8P), dh,
                              dw)
    return out
