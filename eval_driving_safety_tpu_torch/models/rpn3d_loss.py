"""RPN3D loss for DSGN: anchor-free BEV cls/reg/centerness targets and
losses, plus the multi-scale depth smooth-L1 loss.

Counterpart of eval_driving_safety_tpu/models/rpn3d_loss.py. Targets are
computed on the device from zero-padded (B, G, 8) gt arrays with a count
per image, so the loss and its input gradient need no host step.

gt boxes3d row: [x, y_bottom, z, h, w, l, ry, class_id >= 1], zero-padded;
`num_boxes` gives the valid count per image.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.ops.boxes import smooth_l1
from eval_driving_safety_tpu_torch.parallel.sharding import global_sum


def bev_cell_centers(cfg: DSGNConfig, device=None):
    """(Z, X) grids of BEV cell centers (z forward, x right)."""
    xs = torch.linspace(cfg.voxel_x_min, cfg.voxel_x_max, cfg.num_voxels_x,
                        device=device)
    zs = torch.linspace(cfg.voxel_z_min, cfg.voxel_z_max, cfg.num_voxels_z,
                        device=device)
    zz, xx = torch.meshgrid(zs, xs, indexing="ij")
    return zz, xx


class BEVTargets(NamedTuple):
    labels: torch.Tensor       # (B, Z, X) 0 = bg, >= 1 class id
    reg: torch.Tensor          # (B, Z, X, 8)
    centerness: torch.Tensor   # (B, Z, X) in [0, 1]
    pos_mask: torch.Tensor     # (B, Z, X) bool


def assign_bev_targets(boxes3d, num_boxes, cfg: DSGNConfig) -> BEVTargets:
    """A BEV cell is positive iff its center lies inside a gt box's
    expanded BEV rectangle; ties go to the smallest footprint.
    Centerness = sqrt of the product of the normalized insets."""
    b, g = boxes3d.shape[:2]
    zz, xx = bev_cell_centers(cfg, boxes3d.device)
    expand = cfg.centerness_radius
    valid = torch.arange(g, device=boxes3d.device)[None] < num_boxes[:, None]
    per = lambda v: v[:, None, None, :]                  # (B, G) -> (B,1,1,G)
    bx, by, bz = boxes3d[..., 0], boxes3d[..., 1], boxes3d[..., 2]
    bh, bw, bl = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5]
    ry, cls_id = boxes3d[..., 6], boxes3d[..., 7]
    dx = xx[None, ..., None] - per(bx)                   # (B, Z, X, G)
    dz = zz[None, ..., None] - per(bz)
    cu = dx * torch.cos(per(ry)) - dz * torch.sin(per(ry))   # along l
    cv = dx * torch.sin(per(ry)) + dz * torch.cos(per(ry))   # along w
    half_l = torch.clamp_min(bl, 0.1) / 2.0 * expand
    half_w = torch.clamp_min(bw, 0.1) / 2.0 * expand
    inside = (torch.abs(cu) <= per(half_l)) & (torch.abs(cv) <= per(half_w)) \
        & per(valid)
    big = torch.tensor(1e9, dtype=boxes3d.dtype, device=boxes3d.device)
    area = torch.where(valid, bw * bl, big)
    cand = torch.where(inside, per(area), big)
    best = torch.argmin(cand, dim=-1)                    # (B, Z, X)
    pos = inside.any(dim=-1)

    def take(v):                                         # (B, G) at best
        return torch.gather(v, 1, best.reshape(b, -1)).reshape(best.shape)

    labels = torch.where(pos, take(cls_id).to(torch.int64), 0)
    reg = torch.stack([
        take(bx) - xx, take(bz) - zz, take(by),
        torch.log(torch.clamp_min(take(bh), 1e-3)),
        torch.log(torch.clamp_min(take(bw), 1e-3)),
        torch.log(torch.clamp_min(take(bl), 1e-3)),
        torch.sin(take(ry)), torch.cos(take(ry)),
    ], dim=-1)
    u = torch.gather(cu, -1, best[..., None])[..., 0]
    v = torch.gather(cv, -1, best[..., None])[..., 0]
    ctr = torch.sqrt(torch.clamp((1 - torch.abs(u) / take(half_l))
                                 * (1 - torch.abs(v) / take(half_w)),
                                 0.0, 1.0))
    return BEVTargets(labels, reg, torch.where(pos, ctr, 0.0), pos)


def sigmoid_focal_loss(logits, targets01, alpha: float, gamma: float):
    """Elementwise sigmoid focal loss (RetinaNet form)."""
    p = torch.sigmoid(logits)
    ce = torch.logaddexp(torch.zeros_like(logits), logits) \
        - logits * targets01
    p_t = p * targets01 + (1 - p) * (1 - targets01)
    a_t = alpha * targets01 + (1 - alpha) * (1 - targets01)
    return a_t * ((1 - p_t) ** gamma) * ce


def rpn3d_loss(cls_logits, reg_pred, ctr_logits, boxes3d, num_boxes,
               cfg: DSGNConfig) -> Dict[str, torch.Tensor]:
    """cls (B,Z,X,C), reg (B,Z,X,8), ctr (B,Z,X) vs padded gt (B,G,8)."""
    t = assign_bev_targets(boxes3d, num_boxes, cfg)
    num_pos = torch.clamp_min(global_sum(t.pos_mask.sum().float()), 1.0)
    classes = torch.arange(cfg.num_classes, device=cls_logits.device)
    onehot = ((t.labels[..., None] - 1) == classes).float() \
        * t.pos_mask[..., None]
    cls_l = sigmoid_focal_loss(cls_logits, onehot, cfg.focal_alpha,
                               cfg.focal_gamma).sum() / num_pos
    reg_diff = smooth_l1(reg_pred - t.reg).sum(-1)
    reg_l = (reg_diff * t.pos_mask).sum() / num_pos
    ctr_bce = torch.logaddexp(torch.zeros_like(ctr_logits), ctr_logits) \
        - ctr_logits * t.centerness
    ctr_l = (ctr_bce * t.pos_mask).sum() / num_pos
    return {"rpn3d_cls": cls_l, "rpn3d_reg": reg_l,
            "rpn3d_centerness": ctr_l,
            "rpn3d_total": cls_l + reg_l + ctr_l}


def depth_mask(depth_gt, cfg: DSGNConfig):
    return (depth_gt > cfg.min_depth) & (depth_gt <= cfg.max_depth)


def disparity_loss(depth_preds, depth_gt, cfg: DSGNConfig) -> torch.Tensor:
    """Multi-scale smooth-L1 depth loss over gt depths in (min, max],
    weights cfg.disp_loss_weights aligned to the last predictions."""
    mask = depth_mask(depth_gt, cfg)
    denom = torch.clamp_min(global_sum(mask.sum().float()), 1.0)
    weights = cfg.disp_loss_weights[-len(depth_preds):]
    total = torch.zeros((), device=depth_gt.device)
    for w, pred in zip(weights, depth_preds):
        total = total + w * (smooth_l1(pred - depth_gt) * mask).sum() / denom
    return total


def dsgn_total_loss(outputs, depth_gt, boxes3d, num_boxes,
                    cfg: DSGNConfig) -> Tuple[torch.Tensor, Dict]:
    """The scalar the attacks ascend: disparity loss + RPN3D loss."""
    losses = {}
    total = torch.zeros((), device=depth_gt.device)
    if cfg.loss_disp:
        dl = disparity_loss(outputs["depth_preds"], depth_gt, cfg)
        losses["disp"] = dl
        total = total + dl
    if cfg.rpn3d_enable:
        r = rpn3d_loss(outputs["bbox_cls"], outputs["bbox_reg"],
                       outputs["bbox_centerness"], boxes3d, num_boxes, cfg)
        losses.update(r)
        total = total + r["rpn3d_total"]
    losses["total"] = total
    return total, losses
