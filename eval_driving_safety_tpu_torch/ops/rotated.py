"""Rotated (oriented) BEV box IoU by convex polygon clipping.

Counterpart of eval_driving_safety_tpu/ops/rotated.py, with the same
static-shape Sutherland-Hodgman clipping and the same EPS rules, batched
over any leading dimensions: it serves the rotated NMS of the decode (on
the device of the boxes) and the AP evaluator (on the CPU).

Box layout (BEV): (cx, cy, w, l, angle). `l` extends along the heading
direction, `w` perpendicular; angle in radians, CCW.
"""
from __future__ import annotations

import torch

MAX_V = 9  # intersection of two convex quads has <= 8 vertices (+1 pad slot)
EPS = 1e-8


def box5_to_corners(boxes5: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corners in CCW order."""
    cx, cy, w, l, ang = boxes5.unbind(-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # local corners CCW: (+l/2,+w/2), (-l/2,+w/2), (-l/2,-w/2), (+l/2,-w/2)
    lx = torch.stack([l, -l, -l, l], dim=-1) * 0.5
    ly = torch.stack([w, w, -w, -w], dim=-1) * 0.5
    x = cx[..., None] + lx * cos[..., None] - ly * sin[..., None]
    y = cy[..., None] + lx * sin[..., None] + ly * cos[..., None]
    return torch.stack([x, y], dim=-1)


def _polygon_area(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first `count` CCW-ordered vertices of
    (..., MAX_V, 2)."""
    idx = torch.arange(MAX_V, device=verts.device)
    nxt = torch.where(idx + 1 >= count[..., None], 0, idx + 1)
    x, y = verts[..., 0], verts[..., 1]
    term = x * torch.gather(y, -1, nxt) - torch.gather(x, -1, nxt) * y
    term = torch.where(idx < count[..., None], term, 0.0)
    return 0.5 * torch.abs(term.sum(-1))


def _clip_by_edge(verts, count, a, b):
    """Clip each polygon (verts[..., :count, :]) by the half-plane left of
    its directed edge a -> b (a, b: (..., 2)).

    Static-shape Sutherland-Hodgman step: each input edge emits up to 2
    output vertices, compacted by an exclusive cumsum. An emission that
    lands past the buffer goes to a discarded slot MAX_V (the JAX
    version's scatter with mode="drop").
    """
    idx = torch.arange(MAX_V, device=verts.device)
    cnt = count[..., None]
    active = idx < cnt
    prev_idx = torch.where(idx == 0, torch.clamp_min(cnt - 1, 0), idx - 1)
    cur = verts
    prev = torch.gather(verts, -2, prev_idx[..., None].expand_as(verts))

    edge = b - a

    def side(p):
        return (edge[..., None, 0] * (p[..., 1] - a[..., None, 1])
                - edge[..., None, 1] * (p[..., 0] - a[..., None, 0]))

    s_cur = side(cur)
    s_prev = side(prev)
    cur_in = s_cur >= -EPS
    prev_in = s_prev >= -EPS

    # intersection of segment prev->cur with the edge line; a near-zero
    # denominator gives t = 0 (division by inf), never inf or nan
    denom = s_prev - s_cur
    t = s_prev / torch.where(torch.abs(denom) < EPS, torch.inf, denom)
    inter = prev + t[..., None] * (cur - prev)

    # emission rules per edge: cross-in -> [inter, cur]; in->in -> [cur];
    # cross-out -> [inter]; out->out -> [].
    emit_inter = active & (cur_in != prev_in)
    emit_cur = active & cur_in

    # order: inter first (if any), then cur
    n_emit = emit_inter.to(torch.int64) + emit_cur.to(torch.int64)
    start = torch.cumsum(n_emit, -1) - n_emit  # exclusive cumsum

    pos_inter = torch.where(emit_inter, start, MAX_V).clamp_max(MAX_V)
    pos_cur = torch.where(emit_cur, start + emit_inter.to(torch.int64),
                          MAX_V).clamp_max(MAX_V)
    out = torch.zeros(verts.shape[:-2] + (MAX_V + 1, 2), dtype=verts.dtype,
                      device=verts.device)
    out.scatter_(-2, pos_inter[..., None].expand_as(inter), inter)
    out.scatter_(-2, pos_cur[..., None].expand_as(cur), cur)
    return out[..., :MAX_V, :], n_emit.sum(-1)


def _intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Areas of intersection of convex quads c1, c2 (..., 4, 2) (broadcast
    against each other)."""
    c1, c2 = torch.broadcast_tensors(c1, c2)
    verts = torch.zeros(c1.shape[:-2] + (MAX_V, 2), dtype=c1.dtype,
                        device=c1.device)
    verts[..., :4, :] = c1
    count = torch.full(c1.shape[:-2], 4, dtype=torch.int64, device=c1.device)
    for i in range(4):
        verts, count = _clip_by_edge(verts, count, c2[..., i, :],
                                     c2[..., (i + 1) % 4, :])
    area = _polygon_area(verts, count)
    return torch.where(count >= 3, area, 0.0)


def rotated_pairwise_iou(boxes_a: torch.Tensor,
                         boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5), (..., M, 5) -> (..., N, M) rotated IoU."""
    ca = box5_to_corners(boxes_a)                     # (..., N, 4, 2)
    cb = box5_to_corners(boxes_b)                     # (..., M, 4, 2)
    area_a = boxes_a[..., 2] * boxes_a[..., 3]
    area_b = boxes_b[..., 2] * boxes_b[..., 3]
    inter = _intersection_area(ca[..., :, None, :, :],
                               cb[..., None, :, :, :])  # (..., N, M)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, EPS)


def kitti_bev_box5(x, z, w, l, ry):
    """KITTI camera-frame BEV box -> this module's (cx, cy, w, l, angle).

    KITTI footprint corners are (x + lu*cos(ry) + wv*sin(ry),
    z - lu*sin(ry) + wv*cos(ry)): `box5_to_corners` with angle = -ry (the
    y-down camera frame flips the rotation sense)."""
    return x, z, w, l, -ry
