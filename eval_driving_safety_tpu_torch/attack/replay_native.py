"""The sweep's replay and resize in C++ (`native/sweep_replay.cpp`) through
ctypes.

Counterpart of eval_driving_safety_tpu/attack/replay_native.py, save its
PNG writer, which is `data/png_store.py` here. One pass per iteration
replays a packed sign trajectory and quantizes it to u8 frames
(`replay_sweep_u8`), and one pass per frame resizes a Stereo R-CNN frame
into v-space with its iteration-0 frame (`resize_v2_q0`). Each computes
the bytes of its plain version: `attack.pgd.replay_pgd_255` /
`replay_pgd_ints` + quantize, and `data.dataset.srcnn_cleanv_host` +
`quantize_v_batch_u8`.

The library is built with g++ at its first use into `_build/`
(utils/native_build.py, `TUNED_FLAGS`). Every function returns its result
or raises: a failed build or load, an array whose size does not fit the
call (ValueError, checked before anything reaches C) or a failed
allocation. ctypes releases the GIL during each call, so the sweep's
replay and writer threads run at once.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from eval_driving_safety_tpu_torch.utils import native_build

SOURCE = native_build.NATIVE_DIR / "sweep_replay.cpp"
BUILD_DIR = native_build.BUILD_DIR
CXX = "g++"
CXX_FLAGS = native_build.TUNED_FLAGS

_U8, _I32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_I, _F = ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "replay_sweep_u8": ((_I32, _U8, _I32, _I32, _I32, _F32, _I, _I, _I, _I,
                         _I, _I, _U8), _I),
    "replay_sweep_u8_b1": ((_I32, _U8, _I32, _I32, _I32, _F32, _I, _I, _I,
                            _I, _I, _I, _U8), _I),
    "resize_v2_q0": ((_U8, _I, _I, _I, _I32, _I32, _I32, _I, _I32, _I32,
                      _I32, _I, _I, _I, _I, _F, _I, _I32, _U8, _I32), None),
}
_INT32_MAX = 2 ** 31 - 1
_lib = None
_lock = threading.Lock()


def native():
    """The sweep library, built at the first call; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = native_build.load(SOURCE, BUILD_DIR, CXX, CXX_FLAGS,
                                    "the sweep replay library")
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


def _u8(a):
    return a.ctypes.data_as(_U8)


def _i32(a):
    return a.ctypes.data_as(_I32)


def _per_sample(x, b: int, dtype, name: str) -> np.ndarray:
    """A scalar or a (b,) array -> a contiguous (b,) array of `dtype`."""
    a = np.asarray(x)
    if a.ndim > 1 or (a.ndim == 1 and a.shape[0] != b):
        raise ValueError(f"{name}: expected a scalar or {b} values, got "
                         f"shape {a.shape}")
    if np.dtype(dtype).kind == "i" and (
            not np.issubdtype(a.dtype, np.integer)
            or np.any(np.abs(a.astype(np.int64)) > _INT32_MAX)):
        raise ValueError(f"{name}: expected int32 integers, got {a}")
    return np.ascontiguousarray(np.broadcast_to(a.astype(dtype), (b,)))


def replay_sweep_u8(clean_v: np.ndarray, packed: np.ndarray, alpha2, eps2,
                    max2, c255, flip_channels: bool,
                    bits: int = 2) -> np.ndarray:
    """(B, H, W, C) clean values (integers, UNDOUBLED) and a packed sign
    trajectory (iters, B, ...) -> (iters, B, H, W, C) u8 frames: iterate
    k + 1 of the doubled-integer update, quantized as trunc(f32(v2) *
    0.5 * c255) and flipped BGR -> RGB when `flip_channels`.

    bits=2: 2-bit `pack_signs` codes, H*W*C/4 bytes per sample and
    iteration; bits=1: the 1-bit positive plane of collect="signs1"
    (valid only when no gradient was exactly zero), H*W*C/8 bytes.
    alpha2, eps2 and max2 are DOUBLED integers and c255 a float, each a
    scalar or one value per sample."""
    if bits not in (1, 2):
        raise ValueError(f"bits must be 1 or 2, got {bits}")
    clean_v = np.ascontiguousarray(clean_v, np.int32)
    packed = np.ascontiguousarray(packed, np.uint8)
    if clean_v.ndim != 4:
        raise ValueError(f"clean_v must be (B, H, W, C), got {clean_v.shape}")
    b, h, w, c = clean_v.shape
    plane = h * w * c
    per_byte = 4 if bits == 2 else 8
    if plane % per_byte:
        raise ValueError(f"H*W*C = {plane} is not a multiple of {per_byte} "
                         f"({bits}-bit signs)")
    if packed.ndim < 2 or packed.shape[1] != b:
        raise ValueError(f"packed must be (iters, {b}, ...), got "
                         f"{packed.shape}")
    iters = packed.shape[0]
    if packed.size != iters * b * plane // per_byte:
        raise ValueError(f"packed holds {packed.size} bytes; {iters} "
                         f"iterations of {b} x {plane} {bits}-bit signs "
                         f"need {iters * b * plane // per_byte}")
    a2 = _per_sample(alpha2, b, np.int32, "alpha2")
    e2 = _per_sample(eps2, b, np.int32, "eps2")
    m2 = _per_sample(max2, b, np.int32, "max2")
    cq = _per_sample(c255, b, np.float32, "c255")
    out = np.empty((iters, b, h, w, c), np.uint8)
    lib = native()
    fn = lib.replay_sweep_u8 if bits == 2 else lib.replay_sweep_u8_b1
    rc = fn(_i32(clean_v), _u8(packed), _i32(a2), _i32(e2), _i32(m2),
            cq.ctypes.data_as(_F32), iters, b, h, w, c,
            1 if flip_channels else 0, _u8(out))
    if rc == 1:
        raise MemoryError("replay_sweep_u8: cannot allocate its tile "
                          "buffers")
    if rc != 0:
        raise RuntimeError(f"replay_sweep_u8 returned {rc}")
    return out


def _axis(wt, n_in: int, name: str):
    i0, i1, r = (np.ascontiguousarray(a, np.int32)
                 for a in (wt.i0, wt.i1, wt.r))
    if not (len(i0) == len(i1) == len(r)):
        raise ValueError(f"{name}: i0, i1 and r differ in length")
    if len(i0) and (min(i0.min(), i1.min()) < 0
                    or max(i0.max(), i1.max()) >= n_in):
        raise ValueError(f"{name}: source indices outside [0, {n_in})")
    return i0, i1, r


def resize_v2_q0(img_u8: np.ndarray, wh, ww, out_w: int, c255: float):
    """One (H0, W0, C) u8 BGR frame and its axis weights
    (exact_resize.AxisWeights) -> (v, q0): v the (out_h, out_w, C) int32
    integer resize scaled by den_h * den_w, zero past the len(ww.i0)
    columns of the crop, and q0 its RGB frame trunc(f32(v) * c255)."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"img must be (H, W, C), got {img.shape}")
    h0, w0, c = img.shape
    i0h, i1h, rh = _axis(wh, h0, "wh")
    i0w, i1w, rw = _axis(ww, w0, "ww")
    out_h, nw = len(i0h), len(i0w)
    if nw > out_w:
        raise ValueError(f"the crop's {nw} columns exceed out_w {out_w}")
    if 255 * wh.den * ww.den > _INT32_MAX:
        raise ValueError("scaled values would overflow int32")
    v = np.zeros((out_h, out_w, c), np.int32)
    q0 = np.zeros((out_h, out_w, c), np.uint8)
    scratch = np.empty((out_h, w0, c), np.int32)
    native().resize_v2_q0(
        _u8(img), h0, w0, c, _i32(i0h), _i32(i1h), _i32(rh), int(wh.den),
        _i32(i0w), _i32(i1w), _i32(rw), int(ww.den), out_h, nw, out_w,
        float(c255), 1, _i32(v), _u8(q0),
        _i32(scratch))
    return v, q0
