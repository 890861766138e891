"""Exact integer bilinear resize, the Stereo R-CNN ingest.

Counterpart of eval_driving_safety_tpu/data/exact_resize.py. Bilinear
weights at half-pixel centres are rationals with denominator 2 * out_size,
so the resize of uint8 pixels is computed in integer arithmetic: v2 =
sum(c_ij * u8_ij) with integer c_ij, exact and the same on the host
(numpy) and on the card (int32 gathers and multiply-adds). The attack
runs in this integer space ("v-space", data.dataset.srcnn_cleanv_*).
The weights follow cv2 INTER_LINEAR and `jax.image.resize` "linear"
when upsampling (src = (d + 0.5) * in / out - 0.5, clamped to the edge).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class AxisWeights(NamedTuple):
    i0: np.ndarray      # (out,) int32 lower source index (edge-clamped)
    i1: np.ndarray      # (out,) int32 upper source index
    r: np.ndarray       # (out,) int32 numerator of the fractional weight
    den: int            # weight denominator


def bilinear_axis_weights(in_size: int, out_size: int,
                          crop: Optional[int] = None) -> AxisWeights:
    """Integer bilinear weights of in_size -> out_size at half-pixel
    centres; `crop` keeps the first N output positions only (the
    network's width) on the same sample grid."""
    n = out_size if crop is None else min(crop, out_size)
    d = np.arange(n, dtype=np.int64)
    den = 2 * out_size
    num = (2 * d + 1) * in_size - out_size      # src = num / den
    lo = num // den                             # floor, negatives too
    r = num - lo * den                          # in [0, den)
    # divide out the gcd common to every weight: the scaled values stay
    # below 2^24, exact in f32 (the integer grid of the attack)
    g = int(np.gcd.reduce(np.concatenate([r, [den]])))
    r = (r // g).astype(np.int32)
    den //= g
    i0 = np.clip(lo, 0, in_size - 1).astype(np.int32)
    i1 = np.clip(lo + 1, 0, in_size - 1).astype(np.int32)
    return AxisWeights(i0, i1, r, int(den))


def resize_v2_host(img_u8: np.ndarray, wh: AxisWeights,
                   ww: AxisWeights) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) int32 scaled by den_h * den_w."""
    if 255 * wh.den * ww.den >= 2 ** 31:
        raise ValueError("scaled values would overflow int32")
    x = img_u8.astype(np.int32)
    v1 = (wh.den - wh.r)[:, None, None] * x[wh.i0] \
        + wh.r[:, None, None] * x[wh.i1]
    return (ww.den - ww.r)[None, :, None] * v1[:, ww.i0] \
        + ww.r[None, :, None] * v1[:, ww.i1]


def resize_v2_device(img_u8: torch.Tensor, ih0, ih1, rh, den_h, iw0, iw1,
                     rw, den_w) -> torch.Tensor:
    """The batched card half: (B, Hp, Wp, C) uint8 (padding past each
    frame is never read) with per-sample int32 weights (B, out_h) /
    (B, out_w) and denominators (B,) -> (B, out_h, out_w, C) int32 scaled
    by den_h * den_w; int32 gathers and multiply-adds, equal to
    `resize_v2_host` bit for bit."""
    x = img_u8.to(torch.int32)
    b, _, wp, c = x.shape

    def take_h(src, idx):
        return torch.gather(src, 1, idx.long()[:, :, None, None].expand(
            -1, -1, src.shape[2], c))

    def take_w(src, idx):
        return torch.gather(src, 2, idx.long()[:, None, :, None].expand(
            -1, src.shape[1], -1, c))

    rh4 = rh[:, :, None, None]
    v1 = (den_h[:, None, None, None] - rh4) * take_h(x, ih0) \
        + rh4 * take_h(x, ih1)
    rw4 = rw[:, None, :, None]
    return (den_w[:, None, None, None] - rw4) * take_w(v1, iw0) \
        + rw4 * take_w(v1, iw1)
