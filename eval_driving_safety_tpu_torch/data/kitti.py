"""KITTI data layer: calibration, labels, detection txts, u8 image IO.

Counterpart of eval_driving_safety_tpu/data/kitti.py for the attack,
training and predict paths, with the same file formats. Images are read with cv2
or PIL when one is installed, else with the small PNG decoder here
(8-bit RGB/RGBA, non-interlaced, all five row filters); they are written
as PNGs by zlib alone, so the sweep needs neither library.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Calibration:
    """Stereo calibration (KITTI object devkit). P2/P3 are the 3x4
    rectified projections of the left/right color cameras; the baseline
    is |(P2[0,3] - P3[0,3]) / P2[0,0]|."""
    P2: np.ndarray
    P3: np.ndarray
    R0: np.ndarray = field(default_factory=lambda: np.eye(3))
    Tr_velo_to_cam: Optional[np.ndarray] = None

    @property
    def f_u(self) -> float:
        return float(self.P2[0, 0])

    @property
    def f_v(self) -> float:
        return float(self.P2[1, 1])

    @property
    def c_u(self) -> float:
        return float(self.P2[0, 2])

    @property
    def c_v(self) -> float:
        return float(self.P2[1, 2])

    @property
    def baseline(self) -> float:
        return abs(float((self.P2[0, 3] - self.P3[0, 3]) / self.P2[0, 0]))

    def project_rect_to_image(self, pts3d: np.ndarray) -> np.ndarray:
        """(N, 3) rectified-camera points -> (N, 2) left-image pixels."""
        hom = np.concatenate(
            [pts3d, np.ones((pts3d.shape[0], 1), dtype=pts3d.dtype)], axis=1)
        uvw = hom @ self.P2.T
        return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)

    @staticmethod
    def default(f_u: float = 721.5377, c_u: float = 609.5593,
                c_v: float = 172.854, baseline: float = 0.54) -> "Calibration":
        """A KITTI-like calibration for tests and synthetic data."""
        P2 = np.array([[f_u, 0.0, c_u, 44.85728],
                       [0.0, f_u, c_v, 0.2163791],
                       [0.0, 0.0, 1.0, 2.745884e-3]])
        P3 = P2.copy()
        P3[0, 3] = P2[0, 3] - baseline * f_u
        return Calibration(P2=P2, P3=P3)


def read_calib(path: str) -> Calibration:
    """Parse a KITTI object calib txt file."""
    mats: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, vals = line.split(":", 1)
            mats[key.strip()] = np.array([float(v) for v in vals.split()])
    tr = mats.get("Tr_velo_to_cam")
    return Calibration(P2=mats["P2"].reshape(3, 4),
                       P3=mats["P3"].reshape(3, 4),
                       R0=mats.get("R0_rect", np.eye(3).ravel()).reshape(3, 3),
                       Tr_velo_to_cam=None if tr is None else tr.reshape(3, 4))


@dataclass
class KittiObject:
    """One KITTI label line (15 fields, optional 16th = score)."""
    type: str
    truncated: float
    occluded: float
    alpha: float
    bbox: np.ndarray        # x1 y1 x2 y2
    dimensions: np.ndarray  # h w l
    location: np.ndarray    # x y z (camera frame, y = bottom)
    rotation_y: float
    score: Optional[float] = None

    @staticmethod
    def from_line(line: str) -> "KittiObject":
        e = line.strip().split(" ")
        return KittiObject(
            type=e[0], truncated=float(e[1]), occluded=float(e[2]),
            alpha=float(e[3]),
            bbox=np.array([float(v) for v in e[4:8]]),
            dimensions=np.array([float(v) for v in e[8:11]]),
            location=np.array([float(v) for v in e[11:14]]),
            rotation_y=float(e[14]),
            score=float(e[15]) if len(e) > 15 else None)

    def to_line(self) -> str:
        parts = [
            self.type,
            f"{self.truncated:.2f}", f"{int(self.occluded)}",
            f"{self.alpha:.2f}",
            *(f"{v:.2f}" for v in self.bbox),
            *(f"{v:.2f}" for v in self.dimensions),
            *(f"{v:.2f}" for v in self.location),
            f"{self.rotation_y:.2f}",
        ]
        if self.score is not None:
            parts.append(f"{self.score:.8f}")
        return " ".join(parts)


def read_label(path: str) -> List[KittiObject]:
    with open(path) as f:
        return [KittiObject.from_line(ln) for ln in f if ln.strip()]


def format_detection_line(cls_name: str, alpha: float, bbox, h: float,
                          w: float, l: float, x: float, y: float, z: float,
                          ry: float, score: float) -> str:
    """One detection in the 16-field KITTI format of the reference's DSGN
    writer; `y` is the box's bottom."""
    return (
        "{} -1 -1 {:.4f} {:.4f} {:.4f} {:.4f} {:.4f} {:.6f} {:.6f} {:.6f} "
        "{:.6f} {:.6f} {:.6f} {:.6f} {:.8f}".format(
            cls_name, alpha, bbox[0], bbox[1], bbox[2], bbox[3],
            h, w, l, x, y, z, ry, score))


def write_detections(path: str, detections: Sequence[dict]) -> None:
    """Write one image's detections: dicts with type, bbox (4,),
    dimensions (h, w, l), location (x, y_bottom, z), rotation_y, score
    and an optional alpha, which defaults to -atan2(x, z) + ry."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for d in detections:
            x, y, z = d["location"]
            h, w, l = d["dimensions"]
            ry = d["rotation_y"]
            alpha = d.get("alpha")
            if alpha is None:
                alpha = -np.arctan2(x, z) + ry
            f.write(format_detection_line(
                d["type"], alpha, d["bbox"], h, w, l, x, y, z, ry,
                d["score"]) + "\n")


def pad_to(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bottom/right zero-pad an (H, W, ...) image to a static shape
    (cropping anything larger)."""
    img = img[:height, :width]
    out = np.zeros((height, width) + img.shape[2:], dtype=img.dtype)
    out[:img.shape[0], :img.shape[1]] = img
    return out


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 paeth)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (line + prev) & 255
        elif ftype in (3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else \
                        (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"PNG row filter {ftype} unknown")
        out[y] = cur
        prev = cur
    return out


def decode_png_rgb(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB or RGBA, non-interlaced PNG -> (H, W, 3) uint8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise ValueError(f"PNG format not supported here (bit depth {depth}, "
                         f"color type {color}, interlace {interlace})")
    bpp = 3 if color == 2 else 4
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    return np.ascontiguousarray(img.reshape(h, w, bpp)[..., :3])


def load_image_u8(path: str) -> np.ndarray:
    """Load an image as uint8 RGB (H, W, 3): cv2, else PIL, else the PNG
    decoder above. All three give the same pixels for a PNG."""
    try:
        import cv2
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is not None:
            return np.ascontiguousarray(bgr[..., ::-1])
    except ImportError:
        pass
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    except ImportError:
        pass
    with open(path, "rb") as f:
        return decode_png_rgb(f.read())


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray, compress_level: int = 0) -> None:
    """Write (H, W, 3) uint8 RGB as a PNG with zlib alone: filter-0 rows,
    deflated at `compress_level` (0 = stored blocks, the fastest; every
    level holds identical pixels)."""
    arr = np.asarray(arr)
    h, w, c = arr.shape
    if c != 3 or arr.dtype != np.uint8:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{arr.shape} {arr.dtype}")
    lines = np.empty((h, 1 + w * c), np.uint8)
    lines[:, 0] = 0
    lines[:, 1:] = arr.reshape(h, w * c)
    comp = zlib.compressobj(int(compress_level))
    idat = comp.compress(lines.tobytes()) + comp.flush()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def save_image(path: str, img: np.ndarray, crop_hw: Optional[tuple] = None,
               compress_level: int = 0) -> None:
    """Save an RGB image as PNG, cropped to `crop_hw` (the frame's size
    before padding). uint8 input is taken as pixels; float input as [0,1]
    RGB, truncated to uint8 as the JAX package's writer does."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if crop_hw is not None:
        arr = arr[:crop_hw[0], :crop_hw[1]]
    write_png(path, np.ascontiguousarray(arr), compress_level)
