"""A PNG codec of the benchmark's own (8-bit RGB, no interlace): the
traffic's frames are written with it and the program's outputs read back
with it, so neither side of a comparison goes through the program's
PNG code."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode(rgb: np.ndarray, level: int = 0) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes deflated at zlib `level`. Level 0
    writes stored blocks of unfiltered rows; any other level filters
    every row with Sub (each byte less the one a pixel to its left), as a
    photo's encoder mostly does, so the reader pays a camera frame's
    inflate and unfilter."""
    a = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = a.shape
    if c != 3:
        raise ValueError(f"encode takes (H, W, 3), got {a.shape}")
    raw = np.zeros((h, 1 + w * 3), np.uint8)
    raw[:, 1:] = a.reshape(h, w * 3)
    if level:
        raw[:, 0] = 1
        raw[:, 4:] = raw[:, 4:] - a.reshape(h, w * 3)[:, :-3]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path: str, rgb: np.ndarray, level: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode(rgb, level))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit gray, RGB or RGBA) -> (H, W, 3) uint8 RGB."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    chans = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, type {ctype}, "
                         f"interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * chans)
    out = np.zeros((h, w * chans), np.int32)
    prev = np.zeros(w * chans, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, chans), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros_like(line)
            for x in range(w * chans):       # Average, Paeth
                a = cur[x - chans] if x >= chans else 0
                c = prev[x - chans] if x >= chans else 0
                pred = {3: (a + prev[x]) // 2,
                        4: int(_paeth(np.int32(a), prev[x], np.int32(c)))
                        }[int(ftype)]
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, chans).astype(np.uint8)
    if chans == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
