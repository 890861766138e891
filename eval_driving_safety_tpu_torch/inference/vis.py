"""Detection visualization: 2D boxes on images and a BEV render.

Counterpart of eval_driving_safety_tpu/inference/vis.py (numpy only): the
left and right images with their boxes stacked, a BEV canvas of
(pseudo-)lidar points and rotated boxes beside them, saved as
`refer/<id>.png`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def draw_detections_2d(image01: np.ndarray, detections: Sequence[dict],
                       score_thresh: float = 0.0) -> np.ndarray:
    """Draw 2D boxes + scores on a [0,1] RGB image (pure numpy)."""
    img = np.array(image01, copy=True)
    h, w = img.shape[:2]
    color = np.array([0.1, 1.0, 0.1])
    for d in detections:
        if d["score"] < score_thresh:
            continue
        x1, y1, x2, y2 = [int(round(v)) for v in d["bbox"]]
        x1, x2 = max(x1, 0), min(x2, w - 1)
        y1, y2 = max(y1, 0), min(y2, h - 1)
        if x2 <= x1 or y2 <= y1:
            continue
        t = max(1, h // 200)
        img[y1:y1 + t, x1:x2] = color
        img[y2 - t:y2, x1:x2] = color
        img[y1:y2, x1:x1 + t] = color
        img[y1:y2, x2 - t:x2] = color
    return img


def _bev_to_px(x, z, *, width: int, height: int, x_range=(-40.0, 40.0),
               z_range=(0.0, 70.0)):
    px = (x - x_range[0]) / (x_range[1] - x_range[0]) * (width - 1)
    pz = (1.0 - (z - z_range[0]) / (z_range[1] - z_range[0])) * (height - 1)
    return px, pz


def draw_bev(detections: Sequence[dict], *, width: int = 400,
             height: int = 500, points: Optional[np.ndarray] = None,
             score_thresh: float = 0.0) -> np.ndarray:
    """BEV canvas: optional (pseudo-)lidar points + rotated det rectangles."""
    canvas = np.zeros((height, width, 3), np.float32)
    if points is not None and len(points):
        px, pz = _bev_to_px(points[:, 0], points[:, 2], width=width,
                            height=height)
        ok = (px >= 0) & (px < width) & (pz >= 0) & (pz < height)
        canvas[pz[ok].astype(int), px[ok].astype(int)] = 0.35
    for d in detections:
        if d["score"] < score_thresh:
            continue
        x, _, z = d["location"]
        _, bw, bl = d["dimensions"]
        ry = d["rotation_y"]
        # rectangle outline in BEV
        cs, sn = math.cos(ry), math.sin(ry)
        for t in np.linspace(-0.5, 0.5, 32):
            for (du, dv) in ((t * bl, -bw / 2), (t * bl, bw / 2),
                             (-bl / 2, t * bw), (bl / 2, t * bw)):
                cx = x + du * cs + dv * sn
                cz = z - du * sn + dv * cs
                px, pz = _bev_to_px(cx, cz, width=width, height=height)
                if 0 <= px < width and 0 <= pz < height:
                    canvas[int(pz), int(px)] = np.array([0.2, 1.0, 0.2])
    return canvas


def save_detection_panel(path: str, image_left01, image_right01, detections,
                         points: Optional[np.ndarray] = None,
                         vis_thresh: float = 0.7) -> None:
    """The reference's panel: left+right with boxes stacked, BEV beside."""
    from eval_driving_safety_tpu_torch.data.kitti import save_image
    left = draw_detections_2d(image_left01, detections, vis_thresh)
    right = draw_detections_2d(image_right01, detections, vis_thresh)
    stack = np.concatenate([left, right], axis=0)
    bev = draw_bev(detections, height=stack.shape[0], points=points,
                   score_thresh=vis_thresh)
    panel = np.concatenate([stack, bev], axis=1)
    save_image(path, panel)
