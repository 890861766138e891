"""Lidar input for the depth ground truth.

Counterpart of the velodyne reader of
eval_driving_safety_tpu/inference/depth_export.py; the depth-map and
pseudo-lidar exports of that module belong to DSGN predict/export, which
is not ported yet.
"""
from __future__ import annotations

import numpy as np


def load_velodyne(path: str) -> np.ndarray:
    """(N, 4) float32 KITTI velodyne scan (x, y, z, reflectance) in the
    sensor frame."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
