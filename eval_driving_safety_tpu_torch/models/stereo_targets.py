"""Fixed-size proposal, anchor-target and proposal-target layers of Stereo
R-CNN, batched over images.

Counterpart of eval_driving_safety_tpu/models/stereo_targets.py. Every
layer returns fixed-size tensors with validity masks, so no shape
depends on the data and the loss path is always on. The anchor and roi
samplers rank by uniform draws, one (B, N) tensor each for the
foreground and the background (`SamplingDraws`); the JAX layers draw
them from `jax.random` keys, and the tests inject those draws here. Top-k
orders keep `lax.top_k`'s: ties go to the lower index first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eval_driving_safety_tpu_torch.ops import boxes as B
from eval_driving_safety_tpu_torch.ops.nms import nms_parallel, top_k_stable

NEG_INF = -1e10


class SamplingDraws(NamedTuple):
    """Uniform [0, 1) draws of the two samplers, per image."""
    anchor_fg: torch.Tensor      # (B, N) over the anchors
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor         # (B, post_nms_top_n + max_gt_boxes)
    roi_bg: torch.Tensor


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image rows: x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


class Proposals(NamedTuple):
    rois_left: torch.Tensor   # (B, P, 5) [batch_idx, x1, y1, x2, y2]
    rois_right: torch.Tensor  # (B, P, 5)
    valid: torch.Tensor       # (B, P) bool


def proposal_layer(cls_prob, deltas6, anchors, im_hw, *, pre_nms_top_n: int,
                   post_nms_top_n: int, nms_thresh: float,
                   min_size: float) -> Proposals:
    """RPN proposals from the joint stereo predictions: cls_prob (B, N, 2)
    softmaxed, deltas6 (B, N, 6), anchors (N, 4). NMS runs on the union
    of the left and right boxes, so a pair survives as a unit. The boxes
    carry the gradient of `deltas6`; the scores only rank."""
    h, w = im_hw
    left, right = B.decode_stereo_boxes(anchors, deltas6)
    left = B.clip_boxes(left, h, w)
    right = B.clip_boxes(right, h, w)
    lw, lh = B.box_wh(left)
    rw, _ = B.box_wh(right)
    ok = (lw >= min_size) & (lh >= min_size) & (rw >= min_size)
    scores = torch.where(ok, cls_prob[..., 1], NEG_INF).detach()
    top_scores, top_idx = top_k_stable(scores, pre_nms_top_n)
    top_left = _take(left, top_idx)
    top_right = _take(right, top_idx)
    union = B.union_boxes(top_left, top_right).detach()
    keep, valid = nms_parallel(union, top_scores, post_nms_top_n, nms_thresh,
                               valid=top_scores > NEG_INF / 2)
    rois_l, rois_r = _take(top_left, keep), _take(top_right, keep)
    bsz, p = valid.shape
    bidx = torch.arange(bsz, dtype=rois_l.dtype,
                        device=rois_l.device)[:, None, None].expand(bsz, p, 1)
    # invalid rois become [b, 0, 0, 0, 0]: a harmless ROIAlign window
    m = valid[..., None]
    zero = torch.zeros((), dtype=rois_l.dtype, device=rois_l.device)
    rois_left = torch.cat([bidx, torch.where(m, rois_l, zero)], dim=-1)
    rois_right = torch.cat([bidx, torch.where(m, rois_r, zero)], dim=-1)
    return Proposals(rois_left, rois_right, valid)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor      # (B, N) in {-1 ignore, 0 bg, 1 fg}
    targets6: torch.Tensor    # (B, N, 6) stereo regression targets
    inside_w: torch.Tensor    # (B, N, 6)
    outside_w: torch.Tensor   # (B, N, 6)


def _top_values(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) -> (B, k) the k largest values of each row, descending."""
    return torch.topk(x, k, dim=-1, sorted=True).values


def anchor_target_layer(anchors, gt_left, gt_right, gt_merge, num_boxes,
                        im_hw, draw_fg, draw_bg, *, batch_size: int = 256,
                        fg_fraction: float = 0.5,
                        positive_overlap: float = 0.7,
                        negative_overlap: float = 0.3) -> AnchorTargets:
    """Anchor labels and stereo regression targets against the merged gt
    boxes: gt_* (B, G, 4) zero-padded, num_boxes (B,), draws (B, N).
    At most fg_fraction * batch_size foreground anchors are kept, those
    of the largest draws, and background ones fill the batch."""
    h, w = im_hw
    n = anchors.shape[0]
    g = gt_merge.shape[1]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < w) & (anchors[:, 3] < h))
    gt_valid = torch.arange(g, device=anchors.device)[None, :] \
        < num_boxes[:, None]                                   # (B, G)
    iou = B.pairwise_iou(anchors, gt_merge)                    # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    max_iou = iou.max(dim=2).values
    argmax_gt = iou.argmax(dim=2)            # the first of equal maxima
    # the best inside anchor of each gt is positive too; an invalid gt's
    # index is n, which marks nothing
    iou_inside = torch.where(inside[None, :, None], iou, -1.0)
    best_per_gt = torch.where(gt_valid, iou_inside.argmax(dim=1), n)
    is_best = (torch.arange(n, device=anchors.device)[None, :, None]
               == best_per_gt[:, None, :]).any(dim=2)
    labels = torch.full((gt_merge.shape[0], n), -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(max_iou < negative_overlap, 0, labels)
    labels = torch.where(is_best | (max_iou >= positive_overlap), 1, labels)
    labels = torch.where(inside[None, :], labels, -1)

    num_fg = int(fg_fraction * batch_size)
    fg_rank = torch.where(labels == 1, draw_fg, -1.0)
    fg_cut = _top_values(fg_rank, num_fg)[:, -1:]
    drop_fg = (labels == 1) & (fg_rank < torch.clamp(fg_cut, min=0.0))
    labels = torch.where(drop_fg, -1, labels)
    n_fg = (labels == 1).sum(dim=1, keepdim=True)
    num_bg = batch_size - torch.clamp(n_fg, max=num_fg)
    bg_rank = torch.where(labels == 0, draw_bg, -1.0)
    bg_sorted = _top_values(bg_rank, batch_size)
    bg_cut = torch.gather(bg_sorted, 1,
                          torch.clamp(num_bg - 1, 0, batch_size - 1))
    labels = torch.where((labels == 0) & (bg_rank < bg_cut), -1, labels)

    t6 = B.encode_stereo_boxes(anchors, _take(gt_left, argmax_gt),
                               _take(gt_right, argmax_gt))
    inside_w = (labels == 1).to(t6.dtype)[..., None].expand_as(t6)
    num_examples = torch.clamp((labels >= 0).sum(dim=1, keepdim=True), min=1)
    outside_w = torch.where(labels >= 0, 1.0 / num_examples, 0.0)
    return AnchorTargets(labels, t6, inside_w,
                         outside_w.to(t6.dtype)[..., None].expand_as(t6))


class RoiTargets(NamedTuple):
    rois_left: torch.Tensor        # (B, R, 5)
    rois_right: torch.Tensor       # (B, R, 5)
    valid: torch.Tensor            # (B, R) a real sampled roi (filler
                                   # slots, taken when few candidates
                                   # exist, are False)
    labels: torch.Tensor           # (B, R) class id, 0 = background
    targets6: torch.Tensor         # (B, R, 6) normalized
    targets_dim_orien: torch.Tensor  # (B, R, 5)
    kpts_label: torch.Tensor       # (B, R) in [0, 4 * GRID)
    kpts_weight: torch.Tensor      # (B, R)
    border_left_label: torch.Tensor   # (B, R) in [0, GRID)
    border_left_weight: torch.Tensor
    border_right_label: torch.Tensor
    border_right_weight: torch.Tensor
    inside_w: torch.Tensor         # (B, R, 6) foreground-only mask


def proposal_target_layer(props: Proposals, gt_left, gt_right, gt_dim_orien,
                          gt_kpts, num_boxes, draw_fg, draw_bg, *,
                          roi_batch_size: int = 128,
                          fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                          bg_thresh_hi: float = 0.5,
                          bg_thresh_lo: float = 0.0,
                          bbox_means=(0.0, 0.0, 0.0, 0.0),
                          bbox_stds=(0.1, 0.1, 0.2, 0.2),
                          kpts_grid: int = 28) -> RoiTargets:
    """Sample a fixed roi minibatch with stereo, dimension-orientation and
    keypoint targets. gt_left/gt_right (B, G, 5) [x1, y1, x2, y2, cls];
    gt_dim_orien (B, G, 5) [h, w, l, sin, cos]; gt_kpts (B, G, 6)
    [kpt_type, kpt_u, border_lu, border_ru, 0, 0] in left-image pixels
    (type < 0: no keypoint); draws (B, P + G). The targets carry the
    gradient of the proposals' boxes."""
    dev, dt = gt_left.device, gt_left.dtype
    stds = torch.tensor(bbox_stds, dtype=dt, device=dev)
    means = torch.tensor(bbox_means, dtype=dt, device=dev)
    stds6 = torch.cat([stds, stds[0:1], stds[2:3]])
    means6 = torch.cat([means, means[0:1], means[2:3]])
    bsz, g = gt_left.shape[:2]
    gt_valid = torch.arange(g, device=dev)[None, :] < num_boxes[:, None]
    # the gt boxes are candidate rois too
    rl, rr = props.rois_left, props.rois_right
    all_l = torch.cat([rl, torch.cat([rl[:, :1, :1].expand(bsz, g, 1),
                                      gt_left[..., :4]], dim=-1)], dim=1)
    all_r = torch.cat([rr, torch.cat([rr[:, :1, :1].expand(bsz, g, 1),
                                      gt_right[..., :4]], dim=-1)], dim=1)
    all_valid = torch.cat([props.valid, gt_valid], dim=1)

    iou = B.pairwise_iou(all_l[..., 1:].detach(), gt_left[..., :4])
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    max_iou = torch.where(all_valid, iou.max(dim=2).values, -1.0)
    gt_assign = iou.argmax(dim=2)
    is_fg = max_iou >= fg_thresh
    is_bg = (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo) & all_valid

    fg_per_img = int(fg_fraction * roi_batch_size)
    fg_score = torch.where(is_fg, 1.0 + draw_fg, 0.0)
    bg_score = torch.where(is_bg, 1.0 + draw_bg, 0.0)
    fg_vals, fg_idx = top_k_stable(fg_score, fg_per_img)
    bg_vals, bg_idx = top_k_stable(bg_score, roi_batch_size - fg_per_img)
    fg_ok, bg_ok = fg_vals > 0.0, bg_vals > 0.0
    sel = torch.cat([fg_idx, bg_idx], dim=1)
    sel_fg = torch.cat([fg_ok, torch.zeros_like(bg_ok)], dim=1)
    sel_ok = torch.cat([fg_ok, bg_ok], dim=1)

    rois_l, rois_r = _take(all_l, sel), _take(all_r, sel)
    assign = _take(gt_assign, sel)
    gl, gr = _take(gt_left, assign), _take(gt_right, assign)
    labels = torch.where(sel_fg, gl[..., 4].to(torch.int32), 0)
    # left deltas against the left roi, right ones against the right roi
    t_left = B.encode_boxes(rois_l[..., 1:], gl[..., :4])
    t_right = B.encode_boxes(rois_r[..., 1:], gr[..., :4])
    t6 = (torch.cat([t_left, t_right[..., 0:1], t_right[..., 2:3]], dim=-1)
          - means6) / stds6
    tdo = _take(gt_dim_orien, assign)
    inside_w = sel_fg.to(dt)[..., None].expand_as(t6)

    # keypoint and border targets: pixel columns -> bins of the left roi
    roi_x1 = rois_l[..., 1].detach()
    roi_x2 = rois_l[..., 3].detach()
    roi_w = torch.clamp(roi_x2 - roi_x1 + 1.0, min=1.0)

    def to_bin(u):
        return torch.clamp(((u - roi_x1) / roi_w * kpts_grid)
                           .to(torch.int32), 0, kpts_grid - 1)

    gk = _take(gt_kpts, assign)
    kpt_type, kpt_u, bl_u, br_u = gk[..., 0], gk[..., 1], gk[..., 2], \
        gk[..., 3]
    kpt_in = (kpt_u >= roi_x1) & (kpt_u <= roi_x2) & (kpt_type >= 0)
    kpts_label = (torch.clamp(kpt_type.to(torch.int32), 0, 3) * kpts_grid
                  + to_bin(kpt_u))

    def weight(inside):
        return (sel_fg & inside).to(dt)

    return RoiTargets(
        rois_l, rois_r, sel_ok, labels, t6, tdo, kpts_label,
        weight(kpt_in), to_bin(bl_u),
        weight((bl_u >= roi_x1) & (bl_u <= roi_x2)), to_bin(br_u),
        weight((br_u >= roi_x1) & (br_u <= roi_x2)), inside_w)
