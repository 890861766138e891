"""Depth-map and pseudo-lidar export, and the lidar reader of the depth
ground truth.

Counterpart of eval_driving_safety_tpu/inference/depth_export.py:
disparity <-> depth conversion, per-frame depth-map .npy dumps, and
pseudo-lidar point clouds (every valid pixel back-projected through the
calibration to a camera-frame 3D point, written as a KITTI velodyne-style
float32 .bin with reflectance 1). Host numpy on fetched depth maps.
"""
from __future__ import annotations

import os

import numpy as np


def disparity_to_depth(disp: np.ndarray, calib) -> np.ndarray:
    """disp (H, W) pixels -> depth (H, W) meters (f*b/d)."""
    return calib.f_u * calib.baseline / np.maximum(disp, 1e-6)


def depth_to_disparity(depth: np.ndarray, calib) -> np.ndarray:
    return calib.f_u * calib.baseline / np.maximum(depth, 1e-6)


def depth_to_points(depth: np.ndarray, calib, max_depth: float = 80.0,
                    min_depth: float = 0.5, stride: int = 1) -> np.ndarray:
    """(H, W) depth -> (N, 3) camera-frame points (x right, y down,
    z forward)."""
    h, w = depth.shape
    vs, us = np.mgrid[0:h:stride, 0:w:stride]
    z = depth[::stride, ::stride]
    mask = (z > min_depth) & (z < max_depth)
    z = z[mask]
    u = us[mask]
    v = vs[mask]
    x = (u - calib.c_u) * z / calib.f_u
    y = (v - calib.c_v) * z / calib.f_v
    return np.stack([x, y, z], axis=1).astype(np.float32)


def save_depth_map(path: str, depth: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, depth.astype(np.float32))


def save_pseudo_lidar(path: str, depth: np.ndarray, calib,
                      stride: int = 1) -> np.ndarray:
    """Write a velodyne-style (N, 4) float32 .bin (x, y, z, reflectance=1)
    in camera coordinates, as the reference's pseudo-lidar dump does."""
    pts = depth_to_points(depth, calib, stride=stride)
    cloud = np.concatenate(
        [pts, np.ones((pts.shape[0], 1), np.float32)], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cloud.tofile(path)
    return cloud


def load_velodyne(path: str) -> np.ndarray:
    """(N, 4) float32 KITTI velodyne scan (x, y, z, reflectance) in the
    sensor frame."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
