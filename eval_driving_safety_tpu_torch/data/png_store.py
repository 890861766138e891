"""The stored-mode PNG writer in C++ (`native/png_store.cpp`) through
ctypes: the sweep's level-0 writes (`data.kitti.save_image`).

Counterpart of the PNG writer of eval_driving_safety_tpu/attack/
replay_native.py, with its bytes. `data.kitti.write_png` at level 0
holds the same pixels in zlib's blocks: its plain version, for the tests.
The library is built with g++ at its first use into `_build/`
(utils/native_build.py, `TUNED_FLAGS`); a failed build or load, a failed
allocation and a failed open or write raise. ctypes releases the GIL
during the call, so the sweep's writer threads run at once.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from eval_driving_safety_tpu_torch.utils import native_build

SOURCE = native_build.NATIVE_DIR / "png_store.cpp"
BUILD_DIR = native_build.BUILD_DIR
CXX = "g++"
CXX_FLAGS = native_build.TUNED_FLAGS

_lib = None
_lock = threading.Lock()


def native():
    """The PNG library, built at the first call; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = native_build.load(SOURCE, BUILD_DIR, CXX, CXX_FLAGS,
                                    "the PNG writer")
            lib.png_store_write.argtypes = (
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int)
            lib.png_store_write.restype = ctypes.c_int
            _lib = lib
        return _lib


def png_store_write(path: str, arr: np.ndarray) -> None:
    """Write (H, W, 3) RGB or (H, W) / (H, W, 1) gray uint8 pixels as a
    stored-mode PNG in one pass. A view whose rows are contiguous (a crop
    of a larger frame) is read in place with its row stride; other
    layouts are copied first."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[..., None]
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[-1] not in (1, 3):
        raise ValueError(f"png_store_write takes (H, W, 3) or (H, W) uint8, "
                         f"got {np.asarray(arr).shape} {a.dtype}")
    if a.strides[2] != 1 or a.strides[1] != a.shape[2]:
        a = np.ascontiguousarray(a)
    h, w, c = a.shape
    rc = native().png_store_write(
        os.fsencode(path), a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a.strides[0], h, w, c)
    if rc == 1:
        raise MemoryError(f"png_store_write: cannot allocate {h} x {w} x "
                          f"{c}")
    if rc in (3, 4):
        raise OSError(f"png_store_write: cannot "
                      f"{'open' if rc == 3 else 'write'} {path}")
    if rc != 0:
        raise RuntimeError(f"png_store_write returned {rc} for {path}")
