"""Axis-aligned box ops: IoU, Faster R-CNN deltas, the stereo 6-coordinate
deltas, clipping; and the smooth-L1 of the box losses.

Counterpart of eval_driving_safety_tpu/ops/boxes.py. Boxes are [x1, y1,
x2, y2] with inclusive corners (width = x2 - x1 + 1, the legacy Faster
R-CNN convention). Every function broadcasts over leading axes.
"""
from __future__ import annotations

import torch

EPS = 1e-8


def box_wh(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w, h


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w, h = box_wh(boxes)
    return torch.clamp(w, min=0.0) * torch.clamp(h, min=0.0)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M) IoU, +1 width convention."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(x2 - x1 + 1.0, min=0.0)
    ih = torch.clamp(y2 - y1 + 1.0, min=0.0)
    inter = iw * ih
    union = (box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :]
             - inter)
    return inter / torch.clamp(union, min=EPS)


def _centre(boxes: torch.Tensor):
    w, h = box_wh(boxes)
    return w, h, boxes[..., 0] + 0.5 * (w - 1.0), boxes[..., 1] + 0.5 * (h - 1.0)


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Anchor -> gt regression targets (dx, dy, dw, dh)."""
    aw, ah, acx, acy = _centre(anchors)
    gw, gh, gcx, gcy = _centre(gt)
    dx = (gcx - acx) / torch.clamp(aw, min=EPS)
    dy = (gcy - acy) / torch.clamp(ah, min=EPS)
    dw = torch.log(torch.clamp(gw, min=1.0) / torch.clamp(aw, min=EPS))
    dh = torch.log(torch.clamp(gh, min=1.0) / torch.clamp(ah, min=EPS))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to anchors -> boxes."""
    aw, ah, acx, acy = _centre(anchors)
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -10.0, 4.0)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10.0, 4.0)) * ah
    return torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                        cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)], dim=-1)


def encode_stereo_boxes(anchors: torch.Tensor, gt_left: torch.Tensor,
                        gt_right: torch.Tensor) -> torch.Tensor:
    """Joint stereo targets [dxl, dy, dwl, dh, dxr, dwr]: the left box's
    four deltas, then the right box's dx and dw."""
    left = encode_boxes(anchors, gt_left)
    right = encode_boxes(anchors, gt_right)
    return torch.cat([left, right[..., 0:1], right[..., 2:3]], dim=-1)


def decode_stereo_boxes(anchors: torch.Tensor, deltas6: torch.Tensor):
    """Inverse of `encode_stereo_boxes` -> (left_boxes, right_boxes); the
    right box shares the left one's rows (rectified stereo)."""
    left = decode_boxes(anchors, deltas6[..., :4])
    right_deltas = torch.stack([deltas6[..., 4], deltas6[..., 1],
                                deltas6[..., 5], deltas6[..., 3]], dim=-1)
    right = decode_boxes(anchors, right_deltas)
    right = torch.stack([right[..., 0], left[..., 1], right[..., 2],
                         left[..., 3]], dim=-1)
    return left, right


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp boxes to the image, [0, W-1] x [0, H-1]."""
    return torch.stack([torch.clamp(boxes[..., 0], 0.0, width - 1.0),
                        torch.clamp(boxes[..., 1], 0.0, height - 1.0),
                        torch.clamp(boxes[..., 2], 0.0, width - 1.0),
                        torch.clamp(boxes[..., 3], 0.0, height - 1.0)],
                       dim=-1)


def union_boxes(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The box spanning a left and a right box."""
    return torch.stack([torch.minimum(left[..., 0], right[..., 0]),
                        torch.minimum(left[..., 1], right[..., 1]),
                        torch.maximum(left[..., 2], right[..., 2]),
                        torch.maximum(left[..., 3], right[..., 3])], dim=-1)


def smooth_l1(diff: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 with the Faster-R-CNN sigma convention."""
    s2 = sigma * sigma
    absd = torch.abs(diff)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * diff * diff,
                       absd - 0.5 / s2)
