"""Stereo R-CNN: siamese ResNet + FPN, a joint stereo RPN, per-roi stereo
box / dimension-orientation / keypoint heads, and the six-term loss that
the attack ascends.

Counterpart of eval_driving_safety_tpu/models/stereo_rcnn.py, with its
module names and NHWC layouts, so utils.from_flax maps its weights leaf
for leaf. The proposal, anchor-target and proposal-target layers are
fixed-size (models.stereo_targets); pyramid ROIAlign aligns every roi on
every level and masks (ops.roi_align). No gradient is stopped anywhere
but at ROIAlign's roi coordinates, as in the JAX model: the rcnn box
targets carry the gradient of the sampled rois back into the RPN's box
predictions.

Compute dtypes follow the JAX model's: with `cfg.dtype="bfloat16"` the
trunk and heads compute in bf16, and the decode, softmaxes and losses in
f32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.models.common import (Conv, ConvTranspose,
                                                         Dense,
                                                         lecun_normal_,
                                                         resize_bilinear)
from eval_driving_safety_tpu_torch.models.fpn import FPN
from eval_driving_safety_tpu_torch.models.resnet import ResNet
from eval_driving_safety_tpu_torch.models.stereo_targets import (
    SamplingDraws, anchor_target_layer, proposal_layer, proposal_target_layer)
from eval_driving_safety_tpu_torch.ops import boxes as B
from eval_driving_safety_tpu_torch.ops.anchors import (fpn_feat_shapes,
                                                       pyramid_anchors)
from eval_driving_safety_tpu_torch.ops.roi_align import pyramid_roi_align
from eval_driving_safety_tpu_torch.parallel.sharding import (
    global_mean, global_sum, is_first_share)

LOSS_NAMES = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_bbox",
              "rcnn_dim_orien", "rcnn_kpts")


class StereoRCNNOutputs(NamedTuple):
    rois_left: torch.Tensor        # (B, R, 5) [batch_idx, x1, y1, x2, y2]
    rois_right: torch.Tensor       # (B, R, 5)
    roi_valid: torch.Tensor        # (B, R)
    cls_prob: torch.Tensor         # (B, R, C)
    bbox_pred: torch.Tensor        # (B, R, 6 * C) normalized stereo deltas
    dim_orien_pred: torch.Tensor   # (B, R, 5 * C)
    kpts_prob: torch.Tensor        # (B, R, 4 * G)
    left_border_prob: torch.Tensor   # (B, R, G)
    right_border_prob: torch.Tensor  # (B, R, G)
    rois_label: Optional[torch.Tensor]  # (B, R), None in infer mode
    losses: dict                   # the six terms (zeros in infer mode)


def _ce(logits, labels):
    """Per-row cross-entropy of (N, K) logits at (N,) labels."""
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - ll


def _masked_mean_ce(logits, labels, mask):
    """Cross-entropy averaged over `mask`; 0 if the mask is empty."""
    ce = _ce(logits, labels) * mask
    return ce.sum() / torch.clamp(global_sum(mask.sum()), min=1.0)


def _weighted_ce(logits, labels, weights):
    """Per-row cross-entropy times `weights`, summed, and divided by the
    weights' sum where that is at least 1 (the keypoint-loss rule)."""
    ce = (_ce(logits, labels) * weights).sum()
    wsum = global_sum(weights.sum())
    return torch.where(wsum < 1.0, ce, ce / torch.clamp(wsum, min=1.0))


def _smooth_l1_term(pred, target, inside_w, sigma=1.0):
    """smooth_l1(inside_w * (pred - target)) summed over the coordinates,
    averaged over the rows."""
    per = B.smooth_l1(inside_w * (pred - target), sigma=sigma)
    return global_mean(per.sum(dim=-1))


class StereoRPNHead(nn.Module):
    """One RPN conv shared by both views and all levels; objectness and
    6-coordinate stereo deltas from the concatenated views."""

    def __init__(self, cin: int, num_anchors: int = 3,
                 trunk_channels: int = 512, dtype=torch.float32):
        super().__init__()
        self.rpn_conv = Conv(cin, trunk_channels, 3, bias=True, dtype=dtype)
        self.rpn_cls = Conv(2 * trunk_channels, num_anchors * 2, 1,
                            bias=True, dtype=dtype)
        self.rpn_box = Conv(2 * trunk_channels, num_anchors * 6, 1,
                            bias=True, dtype=dtype)
        self.num_anchors = num_anchors

    def forward(self, feats_left, feats_right):
        cls_all, box_all = [], []
        for fl, fr in zip(feats_left, feats_right):
            x = torch.cat([torch.relu(self.rpn_conv(fl)),
                           torch.relu(self.rpn_conv(fr))], dim=-1)
            b, h, w, _ = x.shape
            # NHWC: flattened as (row, column, anchor), the anchors' order
            cls_all.append(self.rpn_cls(x).reshape(b, h * w * self.num_anchors,
                                                   2))
            box_all.append(self.rpn_box(x).reshape(b, h * w * self.num_anchors,
                                                   6))
        return torch.cat(cls_all, dim=1), torch.cat(box_all, dim=1)


class RCNNHead(nn.Module):
    """Per-roi head on the concatenated (P, P, 2C) pooled features,
    flattened in that (row, column, channel) order."""

    def __init__(self, cin: int, num_classes: int, hidden: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(cin, hidden, dtype)
        self.fc2 = Dense(hidden, hidden, dtype)
        self.cls_score = Dense(hidden, num_classes, dtype)
        self.bbox_pred = Dense(hidden, 6 * num_classes, dtype)
        self.dim_orien_pred = Dense(hidden, 5 * num_classes, dtype)

    def forward(self, pooled):
        x = pooled.reshape(pooled.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x), self.dim_orien_pred(x)


class KeypointHead(nn.Module):
    """Left-view keypoint and border head: (N, 2P, 2P, C) -> (N, 6, G)
    logits (4 keypoint types, left border, right border), each a G-bin
    distribution over the roi's columns (the conv logits summed over
    rows)."""

    def __init__(self, cin: int, kpts_grid: int = 28, channels: int = 256,
                 num_convs: int = 4, dtype=torch.float32):
        super().__init__()
        for i in range(num_convs):
            self.add_module(f"kpts_conv{i + 1}",
                            Conv(cin if i == 0 else channels, channels, 3,
                                 bias=True, dtype=dtype))
        self.kpts_deconv = ConvTranspose(channels, channels, 2, dtype)
        self.kpts_class = Conv(channels, 6, 1, bias=True, dtype=dtype)
        self.num_convs, self.kpts_grid = num_convs, kpts_grid

    def forward(self, pooled):
        x = pooled
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"kpts_conv{i + 1}")(x))
        x = torch.relu(self.kpts_deconv(x))
        if x.shape[1] != self.kpts_grid:
            x = resize_bilinear(x, self.kpts_grid, self.kpts_grid)
        return self.kpts_class(x).sum(dim=1).transpose(1, 2)


class StereoRCNN(nn.Module):
    """Stereo R-CNN with the loss path always on (`mode="attack"`), or
    the heads on every post-NMS proposal (`mode="infer"`)."""

    def __init__(self, cfg: StereoRCNNConfig):
        super().__init__()
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.compute_dtype = dt
        w, c = cfg.backbone_width, cfg.fpn_channels
        self.backbone = ResNet(cfg.backbone_blocks, w, dtype=dt)
        self.fpn = FPN((4 * w, 8 * w, 16 * w, 32 * w), c, dtype=dt)
        self.rpn = StereoRPNHead(c, len(cfg.anchor_ratios), dtype=dt)
        self.rcnn = RCNNHead(cfg.pooling_size ** 2 * 2 * c, cfg.num_classes,
                             dtype=dt)
        self.kpts = KeypointHead(c, cfg.kpts_grid, num_convs=cfg.kpts_convs,
                                 dtype=dt)
        shapes = fpn_feat_shapes(cfg.input.height, cfg.input.width,
                                 cfg.feat_strides)
        anchors = pyramid_anchors(shapes, tuple(cfg.feat_strides),
                                  tuple(cfg.anchor_scales),
                                  tuple(cfg.anchor_ratios))
        # a table of the input size, not a parameter: not saved
        self.register_buffer("anchors", torch.from_numpy(anchors.copy()),
                             persistent=False)

    def init_weights(self, seed: int = 0) -> "StereoRCNN":
        """Fresh init with Flax's distributions: lecun-normal kernels
        (fan_in of the Flax layout), zero biases, BN scale 1, mean 0,
        var 1."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            w = getattr(mod, "weight", None)
            if not isinstance(w, nn.Parameter):
                continue
            fan_in = (w.shape[0] * w.shape[2] * w.shape[3]
                      if isinstance(mod, ConvTranspose) else w[0].numel())
            lecun_normal_(w, fan_in, g)
        return self

    def sample_draws(self, batch: int,
                     generator: torch.Generator) -> SamplingDraws:
        """The samplers' uniform draws for a batch, from `generator` (on
        the model's device): over the anchors, and over the proposals and
        gt boxes."""
        n_rois = self.cfg.post_nms_top_n + self.cfg.max_gt_boxes

        def u(n):
            return torch.rand(batch, n, generator=generator,
                              device=self.anchors.device)
        n = self.anchors.shape[0]
        return SamplingDraws(u(n), u(n), u(n_rois), u(n_rois))

    def extract_pyramids(self, im_left, im_right):
        """p2..p6 of each view, one backbone call per view."""
        dt = self.compute_dtype
        pl = self.fpn(*self.backbone(im_left.to(dt)))
        pr = self.fpn(*self.backbone(im_right.to(dt)))
        return pl, pr

    def forward(self, im_left, im_right, gt: Optional[dict] = None,
                draws: Optional[SamplingDraws] = None,
                mode: str = "attack") -> StereoRCNNOutputs:
        """im_left/im_right (B, H, W, 3) BGR pixels minus the means, at the
        config's input size. gt: gt_left (B, G, 5), gt_right (B, G, 5),
        gt_merge (B, G, 4), gt_dim_orien (B, G, 5), gt_kpts (B, G, 6),
        num_boxes (B,) (`make_gt_batch`); it and the samplers' `draws`
        are needed in "attack" mode."""
        cfg = self.cfg
        bsz, height, width, _ = im_left.shape
        if (height, width) != (cfg.input.height, cfg.input.width):
            raise ValueError(f"images of {height}x{width}, the anchor table "
                             f"is of {cfg.input.height}x{cfg.input.width}")
        pl, pr = self.extract_pyramids(im_left, im_right)
        rpn_cls_logits, rpn_box_pred = self.rpn(pl, pr)
        rpn_cls_logits = rpn_cls_logits.float()
        rpn_box_pred = rpn_box_pred.float()
        anchors = self.anchors
        props = proposal_layer(
            torch.softmax(rpn_cls_logits, dim=-1), rpn_box_pred, anchors,
            (height, width), pre_nms_top_n=cfg.pre_nms_top_n,
            post_nms_top_n=cfg.post_nms_top_n, nms_thresh=cfg.rpn_nms_thresh,
            min_size=cfg.rpn_min_size)
        zero = torch.zeros((), device=im_left.device)
        losses = {k: zero for k in LOSS_NAMES}

        if mode == "attack":
            if gt is None or draws is None:
                raise ValueError("attack mode needs gt and draws")
            at = anchor_target_layer(
                anchors, gt["gt_left"][..., :4], gt["gt_right"][..., :4],
                gt["gt_merge"][..., :4], gt["num_boxes"], (height, width),
                draws.anchor_fg, draws.anchor_bg,
                batch_size=cfg.rpn_batch_size,
                fg_fraction=cfg.rpn_fg_fraction,
                positive_overlap=cfg.rpn_positive_overlap,
                negative_overlap=cfg.rpn_negative_overlap)
            losses["rpn_cls"] = _masked_mean_ce(
                rpn_cls_logits.reshape(-1, 2),
                torch.clamp(at.labels, min=0).reshape(-1),
                (at.labels >= 0).reshape(-1).float())
            # sigma-3 smooth-L1 with inside and outside weights
            diff = at.inside_w * (rpn_box_pred - at.targets6)
            losses["rpn_box"] = global_mean(
                (B.smooth_l1(diff, sigma=3.0) * at.outside_w).sum(dim=(1, 2)))
            rt = proposal_target_layer(
                props, gt["gt_left"], gt["gt_right"], gt["gt_dim_orien"],
                gt["gt_kpts"], gt["num_boxes"], draws.roi_fg, draws.roi_bg,
                roi_batch_size=cfg.roi_batch_size,
                fg_fraction=cfg.roi_fg_fraction, fg_thresh=cfg.roi_fg_thresh,
                bg_thresh_hi=cfg.roi_bg_thresh_hi,
                bg_thresh_lo=cfg.roi_bg_thresh_lo,
                bbox_means=cfg.bbox_normalize_means,
                bbox_stds=cfg.bbox_normalize_stds, kpts_grid=cfg.kpts_grid)
            rois_left, rois_right, roi_valid = rt.rois_left, rt.rois_right, \
                rt.valid
            rois_label = rt.labels
        elif mode == "infer":
            rois_left, rois_right, roi_valid = props
            rois_label = None
        else:
            raise ValueError(f"mode {mode!r}")

        n_roi = rois_left.shape[1]
        flat_l = rois_left.reshape(-1, 5)
        flat_r = rois_right.reshape(-1, 5)
        strides4 = tuple(cfg.feat_strides[:4])
        pooled = torch.cat([
            pyramid_roi_align(pl[:4], flat_l, cfg.pooling_size, strides4),
            pyramid_roi_align(pr[:4], flat_r, cfg.pooling_size, strides4)],
            dim=-1)
        cls_score, bbox_pred, dim_orien_pred = (
            t.float() for t in self.rcnn(pooled))
        pooled_k = pyramid_roi_align(pl[:4], flat_l, cfg.pooling_size * 2,
                                     strides4)
        kpts6 = self.kpts(pooled_k).float()                  # (N, 6, G)
        kpts_pred = kpts6[:, :4, :].reshape(-1, 4 * cfg.kpts_grid)
        lb_pred, rb_pred = kpts6[:, 4, :], kpts6[:, 5, :]

        if mode == "attack":
            labels = rt.labels.reshape(-1).long()

            def sel(pred, k):
                # the rows' class-specific k-vectors
                view = pred.reshape(-1, cfg.num_classes, k)
                return torch.gather(view, 1, labels[:, None, None].expand(
                    -1, 1, k))[:, 0]

            roi_ok = rt.valid.reshape(-1).float()
            losses["rcnn_cls"] = _masked_mean_ce(cls_score, labels, roi_ok)
            losses["rcnn_bbox"] = _smooth_l1_term(
                sel(bbox_pred, 6), rt.targets6.reshape(-1, 6),
                rt.inside_w.reshape(-1, 6))
            losses["rcnn_dim_orien"] = _smooth_l1_term(
                sel(dim_orien_pred, 5), rt.targets_dim_orien.reshape(-1, 5),
                roi_ok[:, None])
            l_kpts = _weighted_ce(kpts_pred, rt.kpts_label.reshape(-1),
                                  rt.kpts_weight.reshape(-1))
            l_lb = _weighted_ce(lb_pred, rt.border_left_label.reshape(-1),
                                rt.border_left_weight.reshape(-1))
            l_rb = _weighted_ce(rb_pred, rt.border_right_label.reshape(-1),
                                rt.border_right_weight.reshape(-1))
            losses["rcnn_kpts"] = (l_kpts + l_lb + l_rb) / 3.0

        def per_roi(t):
            return t.reshape(bsz, n_roi, -1)

        return StereoRCNNOutputs(
            rois_left=rois_left, rois_right=rois_right, roi_valid=roi_valid,
            cls_prob=per_roi(torch.softmax(cls_score, dim=-1)),
            bbox_pred=per_roi(bbox_pred),
            dim_orien_pred=per_roi(dim_orien_pred),
            kpts_prob=per_roi(torch.softmax(kpts_pred, dim=-1)),
            left_border_prob=per_roi(torch.softmax(lb_pred, dim=-1)),
            right_border_prob=per_roi(torch.softmax(rb_pred, dim=-1)),
            rois_label=rois_label, losses=losses)


def total_attack_loss(losses: dict, uncert: torch.Tensor) -> torch.Tensor:
    """The six-term uncertainty-weighted loss that the attack ascends:
    sum_i loss_i * exp(-u_i) + u_i."""
    total = torch.zeros((), device=uncert.device)
    first = is_first_share()
    for i, k in enumerate(LOSS_NAMES):
        total = total + losses[k] * torch.exp(-uncert[i])
        if first:                    # the constant once over the ranks
            total = total + uncert[i]
    return total


def make_gt_batch(objects_per_image, calib_list, cfg: StereoRCNNConfig,
                  image_scale=1.0, device=None) -> dict:
    """The padded gt dict of a batch, from lists of KittiObjects (Car and
    Van): the right box is the left one shifted by the disparity of the
    object's centre depth, and the keypoint is the nearest bottom corner
    whose projection lies inside the silhouette. `image_scale` is a
    scalar or one per image."""
    g = cfg.max_gt_boxes
    bsz = len(objects_per_image)
    gt_left = np.zeros((bsz, g, 5), np.float32)
    gt_right = np.zeros((bsz, g, 5), np.float32)
    gt_merge = np.zeros((bsz, g, 4), np.float32)
    gt_dim_orien = np.zeros((bsz, g, 5), np.float32)
    gt_kpts = np.full((bsz, g, 6), -1.0, np.float32)
    num_boxes = np.zeros((bsz,), np.int32)
    scales = (np.full((bsz,), image_scale, np.float64)
              if np.isscalar(image_scale) else np.asarray(image_scale))
    for b, (objs, calib) in enumerate(zip(objects_per_image, calib_list)):
        s = float(scales[b])
        k = 0
        for o in objs:
            if o.type not in ("Car", "Van") or k >= g:
                continue
            x, y, z = o.location
            disp = calib.disparity_from_depth(np.asarray([max(z, 0.1)]))[0]
            bb = o.bbox * s
            gt_left[b, k] = [*bb, 1.0]
            gt_right[b, k] = [bb[0] - disp * s, bb[1], bb[2] - disp * s,
                              bb[3], 1.0]
            gt_merge[b, k] = [min(gt_left[b, k, 0], gt_right[b, k, 0]),
                              bb[1], max(gt_left[b, k, 2], gt_right[b, k, 2]),
                              bb[3]]
            gt_dim_orien[b, k] = [*o.dimensions, np.sin(o.alpha),
                                  np.cos(o.alpha)]
            h3, w3, l3 = o.dimensions
            ry = o.rotation_y
            cx = np.array([l3 / 2, l3 / 2, -l3 / 2, -l3 / 2])
            cz = np.array([w3 / 2, -w3 / 2, -w3 / 2, w3 / 2])
            xs = x + cx * np.cos(ry) + cz * np.sin(ry)
            zs = z - cx * np.sin(ry) + cz * np.cos(ry)
            uv = calib.project_rect_to_image(
                np.stack([xs, np.full(4, y), zs], axis=1))
            us = uv[:, 0] * s
            interior = (us > us.min()) & (us < us.max())
            depth_rank = np.where(interior, zs, np.inf)
            corner = (int(np.argmin(depth_rank))
                      if np.isfinite(depth_rank).any() else int(np.argmin(zs)))
            gt_kpts[b, k] = [float(corner), us[corner], bb[0], bb[2], 0.0,
                             0.0]
            k += 1
        num_boxes[b] = k
    out = dict(gt_left=gt_left, gt_right=gt_right, gt_merge=gt_merge,
               gt_dim_orien=gt_dim_orien, gt_kpts=gt_kpts,
               num_boxes=num_boxes)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
