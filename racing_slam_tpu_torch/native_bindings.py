"""ctypes bindings to the native host library `native/librslam_native.so`
(a threaded OpenCV video decoder and a mask reader, from
native/video_loader.cpp).

The library is committed in the repository and read as data, as the
weights are: this module never builds it. `available()` is False when the
file is missing or it, or the OpenCV runtime it links, cannot be loaded;
utils/video.py then decodes with cv2 in Python.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parent.parent / "native" / "librslam_native.so"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_ip = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _load():
    """The library with its signatures declared, or None."""
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    lib.vl_open.restype = ctypes.c_void_p
    lib.vl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vl_props.restype = None
    lib.vl_props.argtypes = [ctypes.c_void_p, _ip, _ip, ctypes.POINTER(ctypes.c_double)]
    lib.vl_next.restype = ctypes.c_int
    lib.vl_next.argtypes = [ctypes.c_void_p, _u8p]
    lib.vl_close.restype = None
    lib.vl_close.argtypes = [ctypes.c_void_p]
    lib.vl_load_mask.restype = ctypes.c_int
    lib.vl_load_mask.argtypes = [ctypes.c_char_p, _u8p, _ip, _ip, ctypes.c_int]
    return lib


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {LIB_PATH}")
    return lib


class NativeVideoLoader:
    """Threaded native decoder: frames come out as uint8 [H, W] grayscale."""

    def __init__(self, path: str, queue_size: int = 4):
        self._lib = _lib()
        self._h = self._lib.vl_open(str(path).encode(), queue_size)
        if not self._h:
            raise FileNotFoundError(f"cannot open video: {path}")
        w, h, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
        self._lib.vl_props(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps))
        self.width, self.height, self.fps = w.value, h.value, fps.value

    def get_next_frame(self) -> np.ndarray | None:
        if not self._h:  # closed
            return None
        buf = np.empty((self.height, self.width), np.uint8)
        return buf if self._lib.vl_next(self._h, buf.ctypes.data_as(_u8p)) else None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        f = self.get_next_frame()
        if f is None:
            raise StopIteration
        return f

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vl_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def load_mask_native(path: str, max_side: int = 8192) -> np.ndarray:
    """Grayscale mask -> float32 [H, W], 1 where the pixel is nonzero."""
    buf = np.empty(max_side * max_side, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = _lib().vl_load_mask(str(path).encode(), buf.ctypes.data_as(_u8p), ctypes.byref(w),
                             ctypes.byref(h), max_side * max_side)
    if rc != 1:
        raise FileNotFoundError(f"cannot open mask: {path}")
    return (buf[: w.value * h.value].reshape(h.value, w.value) > 0).astype(np.float32)
