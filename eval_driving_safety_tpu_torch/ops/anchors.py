"""Anchors of the FPN stereo RPN, in numpy.

Counterpart of eval_driving_safety_tpu/ops/anchors.py: one scale and
three ratios per pyramid level, all levels concatenated in level-major,
row-major, anchor-minor order, the order in which the RPN head flattens
its (B, H, W, A * k) outputs.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np


def base_anchors(scale: float, ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) centred anchors, +1 width convention, area kept per ratio."""
    out = []
    area = scale * scale
    for r in ratios:
        w = np.round(np.sqrt(area / r))
        h = np.round(w * r)
        out.append([-(w - 1) / 2.0, -(h - 1) / 2.0, (w - 1) / 2.0,
                    (h - 1) / 2.0])
    return np.asarray(out, dtype=np.float32)


@lru_cache(maxsize=16)
def pyramid_anchors(feat_shapes: Tuple[Tuple[int, int], ...],
                    strides: Tuple[int, ...],
                    scales: Tuple[float, ...],
                    ratios: Tuple[float, ...]) -> np.ndarray:
    """All anchors over an FPN, (sum_l H_l * W_l * A, 4) float32. The
    cached array is shared: copy it before writing to it."""
    levels = []
    for (h, w), stride, scale in zip(feat_shapes, strides, scales):
        base = base_anchors(scale, ratios)
        xs = (np.arange(w, dtype=np.float32) + 0.5) * stride - 0.5
        ys = (np.arange(h, dtype=np.float32) + 0.5) * stride - 0.5
        shift_x, shift_y = np.meshgrid(xs, ys)
        shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1)
        anc = shifts[:, :, None, :] + base[None, None]       # (h, w, A, 4)
        levels.append(anc.reshape(-1, 4))
    return np.concatenate(levels, axis=0)


def fpn_feat_shapes(height: int, width: int,
                    strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(np.ceil(height / s)), int(np.ceil(width / s)))
                 for s in strides)
