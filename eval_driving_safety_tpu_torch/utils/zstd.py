"""zstd decompression through the system's libzstd, called with ctypes.

The JAX trainers' orbax checkpoints compress their manifests, B-tree nodes
and array chunks with zstd (utils.orbax_read). Neither Python's standard
library nor PyTorch decodes zstd, and the port installs nothing: it calls
`ZSTD_getFrameContentSize` and `ZSTD_decompress` of the shared library
that the system's own packages link (`libzstd.so.1`). Loading needs no
headers and no build. If the library cannot be loaded, the call raises
and names it; nothing falls back to another decoder.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

SONAME = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2
_DST_SIZE_TOO_SMALL = 70                 # ZSTD_error_dstSize_tooSmall


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded libzstd, its functions typed; raises OSError naming the
    library when the system has none."""
    name = ctypes.util.find_library("zstd") or SONAME
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise OSError(f"cannot load the zstd library {name!r} (the port "
                      f"reads orbax checkpoints through {SONAME}): {e}"
                      ) from None
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorCode.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorCode.restype = ctypes.c_int
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_versionString.argtypes = []
    lib.ZSTD_versionString.restype = ctypes.c_char_p
    return lib


def version() -> str:
    return library().ZSTD_versionString().decode()


def decompress(frame: bytes, size: int | None = None) -> bytearray:
    """The content of the one zstd frame `frame`. `size` is the content's
    length where the caller knows it (a zarr chunk: its shape times its
    item size); the frame's own header must then agree, if it states one.
    Without either, the output buffer doubles until the frame fits.
    Raises ValueError on a corrupt frame or a length that disagrees."""
    lib = library()
    src = bytes(frame)
    declared = lib.ZSTD_getFrameContentSize(src, len(src))
    if declared == _CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    if declared != _CONTENTSIZE_UNKNOWN:
        if size is not None and declared != size:
            raise ValueError(f"zstd frame holds {declared} bytes, "
                             f"expected {size}")
        size = declared
    cap = size if size is not None else max(1 << 16, 4 * len(src))
    while True:
        out = bytearray(cap)
        buf = (ctypes.c_char * cap).from_buffer(out) if cap else None
        n = lib.ZSTD_decompress(buf, cap, src, len(src))
        if not lib.ZSTD_isError(n):
            break
        if (size is None and
                lib.ZSTD_getErrorCode(n) == _DST_SIZE_TOO_SMALL):
            del buf
            cap *= 2
            continue
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(n).decode()}")
    if size is not None and n != size:
        raise ValueError(f"zstd frame holds {n} bytes, expected {size}")
    del buf
    del out[n:]
    return out
