"""FCOS3D-style postprocessor for the DSGN BEV head, and KITTI export.

Counterpart of eval_driving_safety_tpu/inference/fcos3d_post.py: score
map, fixed-size top-k, rotated BEV NMS and the decode to 3D boxes run on
the device of the model's outputs; the (B, max_detections) results cross
to the host in one fetch (`fetch_detections`), where each image's row
becomes KITTI label dicts (class, 2D box from the projected 3D corners,
h/w/l, bottom-centre location, ry, score; alpha = -atan2(x, z) + ry in
the writer).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.rpn3d_loss import bev_cell_centers
from eval_driving_safety_tpu_torch.ops.box_solver import _box_corners_cam
from eval_driving_safety_tpu_torch.ops.nms import rotated_nms, top_k_stable


class Detections3D(NamedTuple):
    """Fixed-size per-image detections (tensors, or arrays on the host)."""
    boxes3d: torch.Tensor   # (B, K, 7) [x, y_bottom, z, h, w, l, ry]
    scores: torch.Tensor    # (B, K)
    classes: torch.Tensor   # (B, K) int, 0-based
    valid: torch.Tensor     # (B, K) bool
    index: torch.Tensor     # (B, K) flat index into the (Z, X, C) map


def decode_bev_outputs(outputs: Dict, cfg: DSGNConfig,
                       pre_nms_top_k: int = 256) -> Detections3D:
    """cls (B,Z,X,C) + reg (B,Z,X,8) + centerness (B,Z,X) -> NMS'd boxes.

    The score map is computed in float64 and rounded to float32 after the
    top-k: f32 sigmoids round differently on the card and the CPU, which
    could order two near-equal candidates differently on the two; exact
    ties (equal logits, frequent once the bf16 head's outputs are cast)
    keep the lower flat index first, as lax.top_k does."""
    cls_logits = outputs["bbox_cls"]
    reg = outputs["bbox_reg"]
    ctr = outputs["bbox_centerness"]
    dev = cls_logits.device
    zz, xx = bev_cell_centers(cfg, dev)
    b, c = cls_logits.shape[0], cls_logits.shape[-1]
    scores_map = torch.sigmoid(cls_logits.double()) \
        * torch.sigmoid(ctr.double())[..., None]            # (B, Z, X, C)
    top_s, top_i = top_k_stable(scores_map.reshape(b, -1), pre_nms_top_k)
    top_s = top_s.float()
    cell = top_i // c
    klass = top_i % c
    rf = torch.gather(reg.reshape(b, -1, 8), 1,
                      cell[..., None].expand(-1, -1, 8))    # (B, K, 8)
    cx = xx.reshape(-1)[cell] + rf[..., 0]
    cz = zz.reshape(-1)[cell] + rf[..., 1]
    cy = rf[..., 2]
    h = torch.exp(rf[..., 3])
    w = torch.exp(rf[..., 4])
    l = torch.exp(rf[..., 5])
    ry = torch.atan2(rf[..., 6], rf[..., 7])
    ok = top_s > cfg.score_thresh
    # KITTI ry -> rotated-op angle is NEGATED (ops.rotated.kitti_bev_box5)
    bev5 = torch.stack([cx, cz, w, l, -ry], dim=-1)
    keep, keep_mask = rotated_nms(bev5, top_s, cfg.max_detections,
                                  cfg.nms_thresh, valid=ok)
    take = lambda v: torch.gather(v, 1, keep)
    b7 = torch.stack([cx, cy, cz, h, w, l, ry], dim=-1)
    b7 = torch.gather(b7, 1, keep[..., None].expand(-1, -1, 7))
    return Detections3D(b7, take(top_s), take(klass),
                        keep_mask & take(ok), take(top_i))


def fetch_detections(dets: Detections3D) -> Detections3D:
    """Device detections -> numpy, in one transfer: the five fields travel
    packed as one (B, K, 11) float32 tensor (classes, the mask and map
    indices below 2^24 are exact in float32)."""
    packed = torch.cat([dets.boxes3d.float(), dets.scores.float()[..., None],
                        dets.classes.float()[..., None],
                        dets.valid.float()[..., None],
                        dets.index.float()[..., None]], dim=-1)
    host = packed.cpu().numpy()
    return Detections3D(host[..., :7], host[..., 7],
                        host[..., 8].astype(np.int64), host[..., 9] > 0.5,
                        host[..., 10].astype(np.int64))


def box3d_corners(box7: np.ndarray) -> np.ndarray:
    """8 corners (camera frame) of [x, y_bottom, z, h, w, l, ry], in the
    box solver's corner convention (ops.box_solver._box_corners_cam)."""
    x, y, z, h, w, l, ry = box7
    return _box_corners_cam(x, y, z, (h, w, l), ry)


def detections_to_kitti(dets: Detections3D, calib, image_hw,
                        class_names=("Car",)) -> list:
    """One image's row of host detections -> list of dicts for
    `data.kitti.write_detections` (2D box = projected 3D corners clipped
    to the image, the reference's convention)."""
    out = []
    h_img, w_img = image_hw
    boxes = np.asarray(dets.boxes3d)
    scores = np.asarray(dets.scores)
    classes = np.asarray(dets.classes)
    valid = np.asarray(dets.valid)
    for i in range(boxes.shape[0]):
        if not valid[i]:
            continue
        b = boxes[i]
        corners = box3d_corners(b)
        uv = calib.project_rect_to_image(corners)
        x1, y1 = uv.min(axis=0)
        x2, y2 = uv.max(axis=0)
        bbox = np.array([max(x1, 0.0), max(y1, 0.0),
                         min(x2, w_img - 1.0), min(y2, h_img - 1.0)])
        if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
            continue
        out.append({
            "type": class_names[int(classes[i]) % len(class_names)],
            "bbox": bbox,
            "dimensions": (float(b[3]), float(b[4]), float(b[5])),
            "location": (float(b[0]), float(b[1]), float(b[2])),
            "rotation_y": float(b[6]),
            "score": float(scores[i]),
        })
    return out
