"""DSGN attack objectives, each `f(outputs, ...) -> scalar` to maximize.

Counterpart of eval_driving_safety_tpu/attack/objectives.py:
* `total_loss` — the detector's training loss (disparity + RPN3D);
* `depth_divergence` — push predicted depth away from ground truth;
* `depth_shift` — pull predicted depth toward gt + `shift_m`.
"""
from __future__ import annotations

import torch

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.rpn3d_loss import (depth_mask,
                                                             dsgn_total_loss)
from eval_driving_safety_tpu_torch.parallel.sharding import global_sum


def total_loss(outputs, depth_gt, boxes3d, num_boxes, cfg: DSGNConfig):
    t, _ = dsgn_total_loss(outputs, depth_gt, boxes3d, num_boxes, cfg)
    return t


def depth_divergence(outputs, depth_gt, cfg: DSGNConfig):
    """Mean |pred - gt| over valid-depth pixels, summed over scales."""
    mask = depth_mask(depth_gt, cfg)
    denom = torch.clamp_min(global_sum(mask.sum().float()), 1.0)
    total = torch.zeros((), device=depth_gt.device)
    for pred in outputs["depth_preds"]:
        total = total + (torch.abs(pred - depth_gt) * mask).sum() / denom
    return total


def depth_shift(outputs, depth_gt, shift_m: float, cfg: DSGNConfig):
    """Negative L1 to (gt + shift_m): ascending it drives predictions to a
    systematic depth offset."""
    mask = depth_mask(depth_gt, cfg)
    denom = torch.clamp_min(global_sum(mask.sum().float()), 1.0)
    target = depth_gt + shift_m
    total = torch.zeros((), device=depth_gt.device)
    for pred in outputs["depth_preds"]:
        total = total - (torch.abs(pred - target) * mask).sum() / denom
    return total
