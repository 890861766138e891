"""3D box geometry of the Stereo R-CNN box solver.

Counterpart of the corner convention of
eval_driving_safety_tpu/ops/box_solver.py, which the DSGN export shares
(inference.fcos3d_post.box3d_corners). The solver itself belongs to the
Stereo R-CNN predict path, which is not ported yet.
"""
from __future__ import annotations

import numpy as np


def _box_corners_cam(x, y, z, dims, theta) -> np.ndarray:
    """8 corners in camera frame; y is the bottom face (KITTI)."""
    h, w, l = dims
    lu = np.array([1, 1, -1, -1], np.float64) * (l / 2.0)
    wv = np.array([1, -1, -1, 1], np.float64) * (w / 2.0)
    cx = x + lu * np.cos(theta) + wv * np.sin(theta)
    cz = z - lu * np.sin(theta) + wv * np.cos(theta)
    bottom = np.stack([cx, np.full(4, y), cz], axis=1)
    top = bottom - np.array([0.0, h, 0.0])
    return np.concatenate([bottom, top], axis=0)
