"""Plain float32 Stereo R-CNN with the attack's six-term loss.

A frozen copy of the port's Stereo R-CNN (`models/stereo_rcnn.py`,
`resnet.py`, `fpn.py`, `stereo_targets.py`, `ops/boxes.py`,
`ops/anchors.py`, `ops/roi_align.py`, `ops/nms.py`) at the same
parameter names: ResNet + FPN, the joint stereo RPN, proposals by greedy
NMS (the fixpoint of "a box survives iff no surviving higher-ranked box
overlaps it", iterated until it holds), the anchor and roi samplers
ranked by the same uniform draws, ROIAlign as a plain bilinear gather
under autograd, and the heads. No batch split over ranks. Every conv and
dense operand passes through `cast` (reference.precision).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.dsgn import FrozenBatchNorm, resize_bilinear
from portbench.reference.precision import exact

NEG_INF = -1e10
LOSS_NAMES = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_bbox",
              "rcnn_dim_orien", "rcnn_kpts")
DRAW_SEED = 11          # the attack CLI's sampler generator seed


def config(sizes: dict) -> SimpleNamespace:
    cfg = SimpleNamespace(**sizes)
    cfg.input = SimpleNamespace(**sizes["input"])
    return cfg


# ------------------------------------------------------------ layers

class Conv(nn.Module):
    """NHWC conv, padding dilation * (k // 2) on every side."""

    def __init__(self, cin, cout, kernel=3, stride=1, bias=False,
                 cast=exact):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel, self.stride, self.cast = kernel, stride, cast

    def forward(self, x):
        y = F.conv2d(self.cast(x.permute(0, 3, 1, 2)), self.cast(self.weight),
                     self.bias, self.stride, self.kernel // 2)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    def __init__(self, cin, cout, cast=exact):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.cast = cast

    def forward(self, x):
        return F.linear(self.cast(x), self.cast(self.weight), self.bias)


class ConvTranspose(nn.Module):
    """k x k, stride k transposed conv (weight (in, out, k, k))."""

    def __init__(self, cin, cout, kernel, cast=exact):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel, self.cast = kernel, cast

    def forward(self, x):
        y = F.conv_transpose2d(self.cast(x.permute(0, 3, 1, 2)),
                               self.cast(self.weight), self.bias,
                               stride=self.kernel)
        return y.permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    def __init__(self, cin, features, stride, cast):
        super().__init__()
        out = features * 4
        self.Conv_0 = Conv(cin, features, 1, cast=cast)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride, cast=cast)
        self.FrozenBatchNorm_1 = FrozenBatchNorm(features)
        self.Conv_2 = Conv(features, out, 1, cast=cast)
        self.FrozenBatchNorm_2 = FrozenBatchNorm(out)
        if cin != out or stride != 1:
            self.downsample_conv = Conv(cin, out, 1, stride, cast=cast)
            self.downsample_bn = FrozenBatchNorm(out)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = torch.relu(self.FrozenBatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.FrozenBatchNorm_1(self.Conv_1(y)))
        y = self.FrozenBatchNorm_2(self.Conv_2(y))
        res = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + res)


class ResNet(nn.Module):
    def __init__(self, blocks, width, cast):
        super().__init__()
        self.stem_conv = Conv(3, width, 7, 2, cast=cast)
        self.stem_bn = FrozenBatchNorm(width)
        cin = width
        for stage, n in enumerate(blocks):
            f = width * 2 ** stage
            for b in range(n):
                self.add_module(f"layer{stage + 1}_block{b}", Bottleneck(
                    cin, f, 2 if (b == 0 and stage > 0) else 1, cast))
                cin = f * 4
        self.blocks = tuple(blocks)

    def forward(self, x):
        y = torch.relu(self.stem_bn(self.stem_conv(x)))
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        feats = []
        for stage, n in enumerate(self.blocks):
            for b in range(n):
                y = getattr(self, f"layer{stage + 1}_block{b}")(y)
            feats.append(y)
        return feats


class FPN(nn.Module):
    def __init__(self, cins, c, cast):
        super().__init__()
        lat = lambda ci: Conv(ci, c, 1, bias=True, cast=cast)
        self.toplayer = lat(cins[3])
        self.latlayer1 = lat(cins[2])
        self.latlayer2 = lat(cins[1])
        self.latlayer3 = lat(cins[0])
        self.smooth1 = Conv(c, c, 3, bias=True, cast=cast)
        self.smooth2 = Conv(c, c, 3, bias=True, cast=cast)
        self.smooth3 = Conv(c, c, 3, bias=True, cast=cast)

    def forward(self, c2, c3, c4, c5):
        up = lambda t, l_: resize_bilinear(t, l_.shape[1], l_.shape[2]) + l_
        p5 = self.toplayer(c5)
        p4 = self.smooth1(up(p5, self.latlayer1(c4)))
        p3 = self.smooth2(up(p4, self.latlayer2(c3)))
        p2 = self.smooth3(up(p3, self.latlayer3(c2)))
        return p2, p3, p4, p5, p5[:, ::2, ::2, :]


class StereoRPNHead(nn.Module):
    def __init__(self, cin, a, cast):
        super().__init__()
        self.rpn_conv = Conv(cin, 512, 3, bias=True, cast=cast)
        self.rpn_cls = Conv(1024, a * 2, 1, bias=True, cast=cast)
        self.rpn_box = Conv(1024, a * 6, 1, bias=True, cast=cast)
        self.a = a

    def forward(self, fls, frs):
        cls, box = [], []
        for fl, fr in zip(fls, frs):
            x = torch.cat([torch.relu(self.rpn_conv(fl)),
                           torch.relu(self.rpn_conv(fr))], dim=-1)
            b, h, w, _ = x.shape
            cls.append(self.rpn_cls(x).reshape(b, h * w * self.a, 2))
            box.append(self.rpn_box(x).reshape(b, h * w * self.a, 6))
        return torch.cat(cls, 1), torch.cat(box, 1)


class RCNNHead(nn.Module):
    def __init__(self, cin, num_classes, cast):
        super().__init__()
        self.fc1 = Dense(cin, 1024, cast)
        self.fc2 = Dense(1024, 1024, cast)
        self.cls_score = Dense(1024, num_classes, cast)
        self.bbox_pred = Dense(1024, 6 * num_classes, cast)
        self.dim_orien_pred = Dense(1024, 5 * num_classes, cast)

    def forward(self, pooled):
        x = torch.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        x = torch.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x), self.dim_orien_pred(x)


class KeypointHead(nn.Module):
    def __init__(self, cin, grid, convs, cast):
        super().__init__()
        for i in range(convs):
            self.add_module(f"kpts_conv{i + 1}", Conv(
                cin if i == 0 else 256, 256, 3, bias=True, cast=cast))
        self.kpts_deconv = ConvTranspose(256, 256, 2, cast)
        self.kpts_class = Conv(256, 6, 1, bias=True, cast=cast)
        self.convs, self.grid = convs, grid

    def forward(self, x):
        for i in range(self.convs):
            x = torch.relu(getattr(self, f"kpts_conv{i + 1}")(x))
        x = torch.relu(self.kpts_deconv(x))
        if x.shape[1] != self.grid:
            x = resize_bilinear(x, self.grid, self.grid)
        return self.kpts_class(x).sum(dim=1).transpose(1, 2)


# ------------------------------------------------------------- boxes

def box_wh(b):
    return b[..., 2] - b[..., 0] + 1.0, b[..., 3] - b[..., 1] + 1.0


def pairwise_iou(a, b):
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]) + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]) + 1.0, min=0.0)
    inter = iw * ih
    area = lambda t: torch.clamp(box_wh(t)[0], min=0.0) * torch.clamp(
        box_wh(t)[1], min=0.0)
    return inter / torch.clamp(area(a) + area(b) - inter, min=1e-8)


def _centre(b):
    w, h = box_wh(b)
    return w, h, b[..., 0] + 0.5 * (w - 1.0), b[..., 1] + 0.5 * (h - 1.0)


def encode(anchors, gt):
    aw, ah, ax, ay = _centre(anchors)
    gw, gh, gx, gy = _centre(gt)
    return torch.stack([
        (gx - ax) / torch.clamp(aw, min=1e-8),
        (gy - ay) / torch.clamp(ah, min=1e-8),
        torch.log(torch.clamp(gw, min=1.0) / torch.clamp(aw, min=1e-8)),
        torch.log(torch.clamp(gh, min=1.0) / torch.clamp(ah, min=1e-8))], -1)


def decode(anchors, d):
    aw, ah, ax, ay = _centre(anchors)
    cx, cy = d[..., 0] * aw + ax, d[..., 1] * ah + ay
    w = torch.exp(torch.clamp(d[..., 2], -10.0, 4.0)) * aw
    h = torch.exp(torch.clamp(d[..., 3], -10.0, 4.0)) * ah
    return torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                        cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)], -1)


def smooth_l1(d, sigma=1.0):
    s2, a = sigma * sigma, torch.abs(d)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * d * d, a - 0.5 / s2)


def pyramid_anchors(cfg) -> np.ndarray:
    levels = []
    for s, scale in zip(cfg.feat_strides, cfg.anchor_scales):
        h, w = (int(math.ceil(cfg.input.height / s)),
                int(math.ceil(cfg.input.width / s)))
        base = []
        for r in cfg.anchor_ratios:
            bw = np.round(np.sqrt(scale * scale / r))
            bh = np.round(bw * r)
            base.append([-(bw - 1) / 2, -(bh - 1) / 2, (bw - 1) / 2,
                         (bh - 1) / 2])
        base = np.asarray(base, np.float32)
        xs = (np.arange(w, dtype=np.float32) + 0.5) * s - 0.5
        ys = (np.arange(h, dtype=np.float32) + 0.5) * s - 0.5
        sx, sy = np.meshgrid(xs, ys)
        shifts = np.stack([sx, sy, sx, sy], -1)
        levels.append((shifts[:, :, None, :] + base[None, None]).reshape(-1, 4))
    return np.concatenate(levels, 0)


def take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def top_k(values, k):
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nms_keep(boxes, scores, valid, thresh):
    """Greedy NMS's keep mask: the fixpoint of "a box survives iff no
    surviving higher-ranked box (stable descending rank) overlaps it over
    `thresh`", iterated from "all valid" until it holds."""
    scores = torch.where(valid, scores, NEG_INF)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    rank = torch.argsort(order, dim=-1)
    dom = (pairwise_iou(boxes, boxes) > thresh) \
        & (rank[..., None, :] < rank[..., :, None]) \
        & valid[..., None, :] & valid[..., :, None]
    keep = valid
    for _ in range(scores.shape[-1] + 1):
        new = valid & ~(dom & keep[..., None, :]).any(-1)
        if torch.equal(new, keep):
            return keep
        keep = new
    raise RuntimeError("NMS found no fixpoint")


# ----------------------------------------------------------- targets

def proposals(cls_prob, deltas6, anchors, cfg):
    h, w = cfg.input.height, cfg.input.width
    left = decode(anchors, deltas6[..., :4])
    right = decode(anchors, torch.stack([deltas6[..., 4], deltas6[..., 1],
                                         deltas6[..., 5], deltas6[..., 3]],
                                        -1))
    right = torch.stack([right[..., 0], left[..., 1], right[..., 2],
                         left[..., 3]], -1)
    clip = lambda b: torch.stack([b[..., 0].clamp(0, w - 1.0),
                                  b[..., 1].clamp(0, h - 1.0),
                                  b[..., 2].clamp(0, w - 1.0),
                                  b[..., 3].clamp(0, h - 1.0)], -1)
    left, right = clip(left), clip(right)
    lw, lh = box_wh(left)
    rw, _ = box_wh(right)
    ok = (lw >= cfg.rpn_min_size) & (lh >= cfg.rpn_min_size) \
        & (rw >= cfg.rpn_min_size)
    scores = torch.where(ok, cls_prob[..., 1], NEG_INF).detach()
    top_s, top_i = top_k(scores, cfg.pre_nms_top_n)
    tl, tr = take(left, top_i), take(right, top_i)
    union = torch.stack([torch.minimum(tl[..., 0], tr[..., 0]),
                         torch.minimum(tl[..., 1], tr[..., 1]),
                         torch.maximum(tl[..., 2], tr[..., 2]),
                         torch.maximum(tl[..., 3], tr[..., 3])], -1).detach()
    keep = nms_keep(union, top_s, top_s > NEG_INF / 2, cfg.rpn_nms_thresh)
    vals, kidx = top_k(torch.where(keep, top_s, NEG_INF), cfg.post_nms_top_n)
    valid = vals > NEG_INF / 2
    rl, rr = take(tl, kidx), take(tr, kidx)
    b, p = valid.shape
    bidx = torch.arange(b, dtype=rl.dtype, device=rl.device)[:, None, None] \
        .expand(b, p, 1)
    m = valid[..., None]
    z = torch.zeros((), dtype=rl.dtype, device=rl.device)
    return (torch.cat([bidx, torch.where(m, rl, z)], -1),
            torch.cat([bidx, torch.where(m, rr, z)], -1), valid)


def anchor_targets(anchors, gt, draw_fg, draw_bg, cfg):
    h, w = cfg.input.height, cfg.input.width
    n, g = anchors.shape[0], gt["gt_merge"].shape[1]
    inside = (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) \
        & (anchors[:, 2] < w) & (anchors[:, 3] < h)
    gt_valid = torch.arange(g, device=anchors.device)[None] \
        < gt["num_boxes"][:, None]
    iou = torch.where(gt_valid[:, None, :],
                      pairwise_iou(anchors, gt["gt_merge"][..., :4]), 0.0)
    max_iou, argmax_gt = iou.max(2).values, iou.argmax(2)
    iou_in = torch.where(inside[None, :, None], iou, -1.0)
    best = torch.where(gt_valid, iou_in.argmax(1), n)
    is_best = (torch.arange(n, device=anchors.device)[None, :, None]
               == best[:, None, :]).any(2)
    labels = torch.full((iou.shape[0], n), -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(max_iou < cfg.rpn_negative_overlap, 0, labels)
    labels = torch.where(is_best | (max_iou >= cfg.rpn_positive_overlap), 1,
                         labels)
    labels = torch.where(inside[None], labels, -1)
    num_fg = int(cfg.rpn_fg_fraction * cfg.rpn_batch_size)
    fg_rank = torch.where(labels == 1, draw_fg, -1.0)
    fg_cut = torch.topk(fg_rank, num_fg, -1).values[:, -1:]
    labels = torch.where((labels == 1) & (fg_rank < fg_cut.clamp(min=0.0)),
                         -1, labels)
    n_fg = (labels == 1).sum(1, keepdim=True)
    num_bg = cfg.rpn_batch_size - n_fg.clamp(max=num_fg)
    bg_rank = torch.where(labels == 0, draw_bg, -1.0)
    bg_sorted = torch.topk(bg_rank, cfg.rpn_batch_size, -1).values
    bg_cut = torch.gather(bg_sorted, 1,
                          (num_bg - 1).clamp(0, cfg.rpn_batch_size - 1))
    labels = torch.where((labels == 0) & (bg_rank < bg_cut), -1, labels)
    el = encode(anchors, take(gt["gt_left"][..., :4], argmax_gt))
    er = encode(anchors, take(gt["gt_right"][..., :4], argmax_gt))
    t6 = torch.cat([el, er[..., 0:1], er[..., 2:3]], -1)
    inside_w = (labels == 1).to(t6.dtype)[..., None].expand_as(t6)
    ne = (labels >= 0).sum(1, keepdim=True).clamp(min=1)
    outside_w = torch.where(labels >= 0, 1.0 / ne, 0.0)[..., None] \
        .expand_as(t6)
    return labels, t6, inside_w, outside_w


def roi_targets(rl, rr, valid, gt, draw_fg, draw_bg, cfg):
    dev, dt = gt["gt_left"].device, gt["gt_left"].dtype
    stds = torch.tensor(cfg.bbox_normalize_stds, dtype=dt, device=dev)
    means = torch.tensor(cfg.bbox_normalize_means, dtype=dt, device=dev)
    stds6 = torch.cat([stds, stds[0:1], stds[2:3]])
    means6 = torch.cat([means, means[0:1], means[2:3]])
    b, g = gt["gt_left"].shape[:2]
    gt_valid = torch.arange(g, device=dev)[None] < gt["num_boxes"][:, None]
    all_l = torch.cat([rl, torch.cat([rl[:, :1, :1].expand(b, g, 1),
                                      gt["gt_left"][..., :4]], -1)], 1)
    all_r = torch.cat([rr, torch.cat([rr[:, :1, :1].expand(b, g, 1),
                                      gt["gt_right"][..., :4]], -1)], 1)
    all_valid = torch.cat([valid, gt_valid], 1)
    iou = torch.where(gt_valid[:, None, :], pairwise_iou(
        all_l[..., 1:].detach(), gt["gt_left"][..., :4]), 0.0)
    max_iou = torch.where(all_valid, iou.max(2).values, -1.0)
    assign_all = iou.argmax(2)
    is_fg = max_iou >= cfg.roi_fg_thresh
    is_bg = (max_iou < cfg.roi_bg_thresh_hi) \
        & (max_iou >= cfg.roi_bg_thresh_lo) & all_valid
    n_fg = int(cfg.roi_fg_fraction * cfg.roi_batch_size)
    fg_v, fg_i = top_k(torch.where(is_fg, 1.0 + draw_fg, 0.0), n_fg)
    bg_v, bg_i = top_k(torch.where(is_bg, 1.0 + draw_bg, 0.0),
                       cfg.roi_batch_size - n_fg)
    fg_ok, bg_ok = fg_v > 0.0, bg_v > 0.0
    sel = torch.cat([fg_i, bg_i], 1)
    sel_fg = torch.cat([fg_ok, torch.zeros_like(bg_ok)], 1)
    sel_ok = torch.cat([fg_ok, bg_ok], 1)
    rois_l, rois_r = take(all_l, sel), take(all_r, sel)
    assign = take(assign_all, sel)
    gl, gr = take(gt["gt_left"], assign), take(gt["gt_right"], assign)
    labels = torch.where(sel_fg, gl[..., 4].to(torch.int32), 0)
    tl, tr = encode(rois_l[..., 1:], gl[..., :4]), \
        encode(rois_r[..., 1:], gr[..., :4])
    t6 = (torch.cat([tl, tr[..., 0:1], tr[..., 2:3]], -1) - means6) / stds6
    x1, x2 = rois_l[..., 1].detach(), rois_l[..., 3].detach()
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    grid = cfg.kpts_grid
    to_bin = lambda u: torch.clamp(((u - x1) / rw * grid).to(torch.int32),
                                   0, grid - 1)
    gk = take(gt["gt_kpts"], assign)
    kt, ku, bl, br = gk[..., 0], gk[..., 1], gk[..., 2], gk[..., 3]
    weight = lambda inside: (sel_fg & inside).to(dt)
    return dict(
        rois_l=rois_l, rois_r=rois_r, valid=sel_ok, labels=labels, t6=t6,
        tdo=take(gt["gt_dim_orien"], assign),
        kpts_label=torch.clamp(kt.to(torch.int32), 0, 3) * grid + to_bin(ku),
        kpts_weight=weight((ku >= x1) & (ku <= x2) & (kt >= 0)),
        bl_label=to_bin(bl), bl_weight=weight((bl >= x1) & (bl <= x2)),
        br_label=to_bin(br), br_weight=weight((br >= x1) & (br <= x2)),
        inside_w=sel_fg.to(dt)[..., None].expand_as(t6))


# ----------------------------------------------------------- roi align

def roi_align(feat, rois, p, scale, s=2):
    """torchvision's ROIAlign at aligned=False with a sampling ratio of
    `s`, as a plain bilinear gather (no gradient to the rois)."""
    rois = rois.detach()
    b, h, w, c = feat.shape
    x1, y1, x2, y2 = (rois[:, i] * scale for i in (1, 2, 3, 4))
    bw = torch.clamp(x2 - x1, min=1.0) / p
    bh = torch.clamp(y2 - y1, min=1.0) / p
    i = (torch.arange(p * s, device=rois.device, dtype=rois.dtype) + 0.5) / s
    yy = (y1[:, None] + i[None] * bh[:, None])[:, :, None]
    xx = (x1[:, None] + i[None] * bw[:, None])[:, None, :]
    oob = (yy < -1.0) | (yy > h * 1.0) | (xx < -1.0) | (xx > w * 1.0)
    yc, xc = yy.clamp(0.0, h - 1.0), xx.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    ly, lx = yc - y0, xc - x0
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=h - 1), (x0i + 1).clamp(max=w - 1)
    flat = feat.reshape(b * h * w, c)
    base = rois[:, 0].long()[:, None, None] * h

    def g(yi, xi):
        idx = ((base + yi) * w + xi).expand(oob.shape)
        return flat.index_select(0, idx.reshape(-1)).view(*oob.shape, c)
    v = (g(y0i, x0i) * ((1 - ly) * (1 - lx))[..., None]
         + g(y0i, x1i) * ((1 - ly) * lx)[..., None]
         + g(y1i, x0i) * (ly * (1 - lx))[..., None]
         + g(y1i, x1i) * (ly * lx)[..., None])
    v = torch.where(oob[..., None], 0.0, v)
    return v.reshape(-1, p, s, p, s, c).mean(dim=(2, 4))


def pyramid_roi_align(feats, rois, p, strides):
    hh = rois[:, 4] - rois[:, 2] + 1.0
    ww = rois[:, 3] - rois[:, 1] + 1.0
    lvl = torch.clamp(torch.round(torch.log(torch.sqrt(torch.clamp(
        hh * ww, min=1.0)) / 224.0) + 4.0), 2, 5).long().detach()
    out = 0
    for i, (f, s) in enumerate(zip(feats, strides)):
        out = out + roi_align(f, rois, p, 1.0 / s) \
            * (lvl == i + 2).float()[:, None, None, None]
    return out


# ------------------------------------------------------------ model

class StereoRCNN(nn.Module):
    def __init__(self, cfg, cast=exact):
        super().__init__()
        self.cfg = cfg
        w, c = cfg.backbone_width, cfg.fpn_channels
        self.backbone = ResNet(cfg.backbone_blocks, w, cast)
        self.fpn = FPN((4 * w, 8 * w, 16 * w, 32 * w), c, cast)
        self.rpn = StereoRPNHead(c, len(cfg.anchor_ratios), cast)
        self.rcnn = RCNNHead(cfg.pooling_size ** 2 * 2 * c, cfg.num_classes,
                             cast)
        self.kpts = KeypointHead(c, cfg.kpts_grid, cfg.kpts_convs, cast)
        self.register_buffer("anchors", torch.from_numpy(
            pyramid_anchors(cfg)), persistent=False)

    def draws(self, batch: int, device):
        """The samplers' draws as the attack CLI makes them per batch."""
        g = torch.Generator(device=device).manual_seed(DRAW_SEED)
        n = self.anchors.shape[0]
        nr = self.cfg.post_nms_top_n + self.cfg.max_gt_boxes
        u = lambda k: torch.rand(batch, k, generator=g, device=device)
        return u(n), u(n), u(nr), u(nr)

    def losses(self, im_left, im_right, gt, draws):
        cfg = self.cfg
        pl = self.fpn(*self.backbone(im_left))
        pr = self.fpn(*self.backbone(im_right))
        cls_logits, box = self.rpn(pl, pr)
        anchors = self.anchors
        rl, rr, valid = proposals(torch.softmax(cls_logits, -1), box,
                                  anchors, cfg)
        a_fg, a_bg, r_fg, r_bg = draws
        labels, t6, in_w, out_w = anchor_targets(anchors, gt, a_fg, a_bg,
                                                 cfg)
        out = {}
        m = (labels >= 0).reshape(-1).float()
        ce = lambda lg, lb: torch.logsumexp(lg, -1) - torch.gather(
            lg, -1, lb.long()[:, None])[:, 0]
        out["rpn_cls"] = (ce(cls_logits.reshape(-1, 2),
                             labels.clamp(min=0).reshape(-1)) * m).sum() \
            / m.sum().clamp(min=1.0)
        out["rpn_box"] = (smooth_l1(in_w * (box - t6), 3.0) * out_w).sum(
            (1, 2)).mean()
        rt = roi_targets(rl, rr, valid, gt, r_fg, r_bg, cfg)
        fl, fr = rt["rois_l"].reshape(-1, 5), rt["rois_r"].reshape(-1, 5)
        st = tuple(cfg.feat_strides[:4])
        pooled = torch.cat([pyramid_roi_align(pl[:4], fl, cfg.pooling_size,
                                              st),
                            pyramid_roi_align(pr[:4], fr, cfg.pooling_size,
                                              st)], -1)
        cls_score, bbox, dimo = self.rcnn(pooled)
        k6 = self.kpts(pyramid_roi_align(pl[:4], fl, cfg.pooling_size * 2,
                                         st))
        kp = k6[:, :4, :].reshape(-1, 4 * cfg.kpts_grid)
        lab = rt["labels"].reshape(-1).long()

        def sel(pred, k):
            v = pred.reshape(-1, cfg.num_classes, k)
            return torch.gather(v, 1, lab[:, None, None].expand(-1, 1, k))[
                :, 0]
        ok = rt["valid"].reshape(-1).float()
        out["rcnn_cls"] = (ce(cls_score, lab) * ok).sum() \
            / ok.sum().clamp(min=1.0)
        out["rcnn_bbox"] = smooth_l1(rt["inside_w"].reshape(-1, 6) * (
            sel(bbox, 6) - rt["t6"].reshape(-1, 6))).sum(-1).mean()
        out["rcnn_dim_orien"] = smooth_l1(ok[:, None] * (
            sel(dimo, 5) - rt["tdo"].reshape(-1, 5))).sum(-1).mean()

        def wce(lg, lb, wt):
            c = (ce(lg, lb.reshape(-1)) * wt.reshape(-1)).sum()
            s = wt.sum()
            return torch.where(s < 1.0, c, c / s.clamp(min=1.0))
        out["rcnn_kpts"] = (wce(kp, rt["kpts_label"], rt["kpts_weight"])
                            + wce(k6[:, 4, :], rt["bl_label"],
                                  rt["bl_weight"])
                            + wce(k6[:, 5, :], rt["br_label"],
                                  rt["br_weight"])) / 3.0
        return out


def total_loss(losses: dict, uncert: torch.Tensor):
    return sum(losses[k] * torch.exp(-uncert[i]) + uncert[i]
               for i, k in enumerate(LOSS_NAMES))


# --------------------------------------------------- inputs and gt

def axis_weights(in_size, out_size, crop=None):
    """Integer bilinear weights at half-pixel centres (i0, i1, r, den),
    divided by the gcd common to all of them."""
    n = out_size if crop is None else min(crop, out_size)
    d = np.arange(n, dtype=np.int64)
    den = 2 * out_size
    num = (2 * d + 1) * in_size - out_size
    lo = num // den
    r = num - lo * den
    g = int(np.gcd.reduce(np.concatenate([r, [den]])))
    return (np.clip(lo, 0, in_size - 1), np.clip(lo + 1, 0, in_size - 1),
            r // g, den // g)


def clean_v(rgb: np.ndarray, cfg):
    """A frame's attack space: its BGR pixels resized to the network's
    rows exactly in integers, v = den_h * den_w * pixel, zero past the
    frame's width; and (K = den_h * den_w, the frame's width there)."""
    oh, ow = rgb.shape[:2]
    out_h, out_w = cfg.input.height, cfg.input.width
    full_w = int(round(ow * (out_h / oh)))
    nw = min(full_w, out_w)
    h0, h1, rh, dh = axis_weights(oh, out_h)
    w0, w1, rw, dw = axis_weights(ow, full_w, nw)
    x = rgb[..., ::-1].astype(np.int64)
    v1 = (dh - rh)[:, None, None] * x[h0] + rh[:, None, None] * x[h1]
    v = (dw - rw)[None, :, None] * v1[:, w0] + rw[None, :, None] * v1[:, w1]
    out = np.zeros((out_h, out_w, 3), np.float32)
    out[:, :nw] = v
    return out, dh * dw, nw


def gt_batch(cars_per_frame, scales, cfg, device):
    """The padded gt of a batch as the attack builds it from the label
    files: right boxes shifted by the disparity of the centre depth, the
    keypoint the nearest bottom corner inside the silhouette."""
    from portbench.frames import P2, P3
    f_u = P2[0, 0]
    baseline = abs((P2[0, 3] - P3[0, 3]) / P2[0, 0])
    g, b = cfg.max_gt_boxes, len(cars_per_frame)
    out = {k: np.zeros((b, g, n), np.float32) for k, n in (
        ("gt_left", 5), ("gt_right", 5), ("gt_merge", 4),
        ("gt_dim_orien", 5))}
    out["gt_kpts"] = np.full((b, g, 6), -1.0, np.float32)
    num = np.zeros((b,), np.int32)
    for i, (cars, s) in enumerate(zip(cars_per_frame, scales)):
        for k, c in enumerate(cars[:g]):
            x, y, z = c.loc
            disp = f_u * baseline / max(max(z, 0.1), 1e-6)
            bb = np.asarray(c.bbox) * s
            out["gt_left"][i, k] = [*bb, 1.0]
            out["gt_right"][i, k] = [bb[0] - disp * s, bb[1],
                                     bb[2] - disp * s, bb[3], 1.0]
            out["gt_merge"][i, k] = [
                min(out["gt_left"][i, k, 0], out["gt_right"][i, k, 0]),
                bb[1], max(out["gt_left"][i, k, 2],
                           out["gt_right"][i, k, 2]), bb[3]]
            out["gt_dim_orien"][i, k] = [*c.dims, np.sin(c.alpha),
                                         np.cos(c.alpha)]
            h3, w3, l3 = c.dims
            cx = np.array([l3 / 2, l3 / 2, -l3 / 2, -l3 / 2])
            cz = np.array([w3 / 2, -w3 / 2, -w3 / 2, w3 / 2])
            xs = x + cx * np.cos(c.ry) + cz * np.sin(c.ry)
            zs = z - cx * np.sin(c.ry) + cz * np.cos(c.ry)
            hom = np.stack([xs, np.full(4, y), zs, np.ones(4)], 1) @ P2.T
            us = hom[:, 0] / np.maximum(hom[:, 2], 1e-9) * s
            interior = (us > us.min()) & (us < us.max())
            rank = np.where(interior, zs, np.inf)
            corner = int(np.argmin(rank)) if np.isfinite(rank).any() \
                else int(np.argmin(zs))
            out["gt_kpts"][i, k] = [float(corner), us[corner], bb[0], bb[2],
                                    0.0, 0.0]
        num[i] = min(len(cars), g)
    out["num_boxes"] = num
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def attack_loss_and_grad(model, cfg, vl, vr, c255, gt, draws, uncert):
    """Loss and its gradient w.r.t. both v-space views at one iterate, fed
    as the attack feeds the model: v * c255 - the BGR means."""
    means = torch.tensor(cfg.input.pixel_means_bgr, device=vl.device)
    xl = vl.detach().requires_grad_(True)
    xr = vr.detach().requires_grad_(True)
    cb = c255[:, None, None, None]
    loss = total_loss(model.losses(xl * cb - means, xr * cb - means, gt,
                                   draws), uncert)
    gl, gr = torch.autograd.grad(loss, (xl, xr))
    return loss.detach(), gl, gr


# ----------------------------------------------------- weights, ops

def init_shapes(model):
    out = []
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if leaf == "weight":
                fan_in = (p.shape[0] * p.shape[2] * p.shape[3]
                          if isinstance(mod, ConvTranspose)
                          else int(np.prod(p.shape[1:])))
                out.append((name, tuple(p.shape), ("kernel", fan_in)))
            elif leaf in ("scale", "var"):
                out.append((name, tuple(p.shape), ("const", 1.0)))
            else:
                out.append((name, tuple(p.shape), ("const", 0.0)))
    return out


def init_shapes_of(config: dict):
    with torch.device("meta"):
        return init_shapes(StereoRCNN(globals()["config"](config["model"])))


def load(config: dict, ckpt: str, device, cast=exact) -> StereoRCNN:
    model = StereoRCNN(globals()["config"](config["model"]), cast)
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True))
    return model.to(device).requires_grad_(False).eval()


def flops_per_unit(config: dict, traffic: dict, kind: str) -> int:
    """Operations of a sweep's pair at batch 1 on this reference (meta
    device): `iters` forward passes with the loss and its input
    gradient. The proposal NMS is counted as its IoU arithmetic is not:
    the flop counter sees matmuls and convs only."""
    from portbench.counts import model_flops
    cfg = globals()["config"](config["model"])
    with torch.device("meta"):
        model = StereoRCNN(cfg).requires_grad_(False)
    h, w = cfg.input.height, cfg.input.width

    def attack():
        x = torch.zeros(1, h, w, 3, device="meta", requires_grad=True)
        means = torch.zeros(3, device="meta")
        feats_l = model.fpn(*model.backbone(x - means))
        feats_r = model.fpn(*model.backbone(x - means))
        cls, box = model.rpn(feats_l, feats_r)
        n = cfg.roi_batch_size
        rois = torch.zeros(n, 5, device="meta")
        st = tuple(cfg.feat_strides[:4])
        pooled = torch.cat([pyramid_roi_align(feats_l[:4], rois,
                                              cfg.pooling_size, st)] * 2, -1)
        c, b, d = model.rcnn(pooled)
        k = model.kpts(pyramid_roi_align(feats_l[:4], rois,
                                         cfg.pooling_size * 2, st))
        loss = cls.sum() + box.sum() + c.sum() + b.sum() + d.sum() + k.sum()
        torch.autograd.grad(loss, x)

    return model_flops(attack) * traffic["iters"]
