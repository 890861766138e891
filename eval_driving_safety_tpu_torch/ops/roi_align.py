"""ROIAlign on NHWC features: one batched gather forward, a scatter-free
backward of two tent-matrix products.

Counterpart of eval_driving_safety_tpu/ops/roi_align.py, with
torchvision's semantics at `aligned=False` and a fixed sampling ratio.
The sampled bilinear values are the separable contraction

    vals[n, p, q, c] = sum_{h,w} Wy[n, p, h] * feat[b_n, h, w, c] * Wx[n, q, w]

with per-roi tent rows Wy, Wx, so the feature gradient is the transposed
pair of tent products: the rows (H) are contracted first, then the batch
one-hot is folded into the column tents and (roi, column) are contracted
in one matrix product. It sums in a fixed order and needs no atomics.
The ROI coordinates get a zero gradient, as torchvision's ROIAlign gives
them. `record_function` names the forward and backward for profiles.

Features are (B, H, W, C); ROIs are (N, 5) [batch_idx, x1, y1, x2, y2] in
image coordinates.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.profiler import record_function


def _sample_coords(rois: torch.Tensor, output_size: int,
                   spatial_scale: float, sampling_ratio: int):
    """Sample-point rows and columns of every roi: (ys, xs), (N, P * s)."""
    p, s = output_size, sampling_ratio
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / p
    bin_h = torch.clamp(y2 - y1, min=1.0) / p
    i = (torch.arange(p * s, device=rois.device, dtype=rois.dtype)
         + 0.5) / s
    ys = y1[:, None] + i[None, :] * bin_h[:, None]
    xs = x1[:, None] + i[None, :] * bin_w[:, None]
    return ys, xs


def _tent_rows(coords: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(N, P) coordinates -> (N, P, n) tent weights of the clamped
    bilinear sample: coordinates clamp to [0, n - 1], and a sample more
    than 1 px outside the map ([-1, n]) weighs nothing."""
    inb = ((coords >= -1.0) & (coords <= float(n))).to(dtype)
    cc = torch.clamp(coords, 0.0, n - 1.0)
    src = torch.arange(n, device=coords.device, dtype=coords.dtype)
    w = torch.clamp(1.0 - torch.abs(src - cc[..., None]), min=0.0)
    return w.to(dtype) * inb[..., None]


def _bilerp(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
            bidx: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear samples (N, Ps, Ps, C) of `feat` at the outer
    product of `ys` and `xs`, in feat's dtype; zero outside [-1, n]."""
    b, h, w, c = feat.shape
    yy, xx = ys[:, :, None], xs[:, None, :]
    oob = (yy < -1.0) | (yy > h * 1.0) | (xx < -1.0) | (xx > w * 1.0)
    yc = torch.clamp(yy, 0.0, h - 1.0)
    xc = torch.clamp(xx, 0.0, w - 1.0)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    ly, lx = yc - y0, xc - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    flat = feat.reshape(b * h * w, c)
    base = bidx[:, None, None] * h

    def g(yi, xi):
        idx = ((base + yi) * w + xi).expand(oob.shape)
        return flat.index_select(0, idx.reshape(-1)).view(*oob.shape, c)

    hy, hx = 1.0 - ly, 1.0 - lx

    def wt(a):
        return a[..., None].to(feat.dtype)

    vals = (g(y0i, x0i) * wt(hy * hx) + g(y0i, x1i) * wt(hy * lx)
            + g(y1i, x0i) * wt(ly * hx) + g(y1i, x1i) * wt(ly * lx))
    return torch.where(oob[..., None], torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device), vals)


class _BilerpSample(torch.autograd.Function):
    """`_bilerp` with the tent-product backward; no coordinate gradient."""

    @staticmethod
    def forward(ctx, feat, ys, xs, bidx):
        with record_function("roi_align_fwd"):
            ctx.save_for_backward(ys, xs, bidx)
            ctx.feat_shape = feat.shape
            return _bilerp(feat, ys, xs, bidx)

    @staticmethod
    def backward(ctx, dvals):
        with record_function("roi_align_bwd"):
            ys, xs, bidx = ctx.saved_tensors
            b, h, w, c = ctx.feat_shape
            n, _, qs, _ = dvals.shape
            dt = dvals.dtype
            wy = _tent_rows(ys, h, dt)                      # (N, Ps, H)
            wx = _tent_rows(xs, w, dt)                      # (N, Qs, W)
            # rows first: (N, 1, H, Ps) @ (N, Qs, Ps, C) -> (N, Qs, H, C)
            t = torch.matmul(wy.transpose(1, 2)[:, None],
                             dvals.transpose(1, 2))
            # the batch one-hot folded into the column tents: (N, Qs, B, W)
            onehot = torch.nn.functional.one_hot(bidx, b).to(dt)
            wxb = wx[:, :, None, :] * onehot[:, None, :, None]
            # one product over (n, q): (B * W, N * Qs) @ (N * Qs, H * C)
            lhs = wxb.permute(2, 3, 0, 1).reshape(b * w, n * qs)
            dfeat = (lhs @ t.reshape(n * qs, h * c)).view(b, w, h, c)
            dfeat = dfeat.transpose(1, 2)
            return dfeat.contiguous(), None, None, None


def roi_align(feat: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign: feat (B, H, W, C), rois (N, 5) -> (N, P, P, C), the mean
    of sampling_ratio^2 bilinear samples per bin."""
    p, s = output_size, sampling_ratio
    ys, xs = _sample_coords(rois.detach(), p, spatial_scale, s)
    bidx = rois[:, 0].detach().to(torch.int64)
    vals = _BilerpSample.apply(feat, ys, xs, bidx)
    n, c = rois.shape[0], feat.shape[-1]
    return vals.reshape(n, p, s, p, s, c).mean(dim=(2, 4))


def roi_levels(rois: torch.Tensor, k0: float = 4.0, canonical: float = 224.0,
               lmin: int = 2, lmax: int = 5) -> torch.Tensor:
    """FPN level of each roi by the reference's natural-log rule
    round(ln(sqrt(h * w) / 224) + 4), clamped to [2, 5] (not the usual
    log2 rule)."""
    h = rois[:, 4] - rois[:, 2] + 1.0
    w = rois[:, 3] - rois[:, 1] + 1.0
    lvl = torch.round(torch.log(torch.sqrt(torch.clamp(h * w, min=1.0))
                                / canonical) + k0)
    return torch.clamp(lvl, lmin, lmax).to(torch.int64)


def pyramid_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      output_size: int,
                      strides: Sequence[int] = (4, 8, 16, 32),
                      sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign over p2..p5: every roi is aligned on every level and its
    own level selected by a mask, so no shape depends on the data."""
    lvls = roi_levels(rois.detach())
    out = None
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        pooled = roi_align(feat, rois, output_size, 1.0 / stride,
                           sampling_ratio)
        sel = (lvls == i + 2).to(pooled.dtype)[:, None, None, None]
        out = pooled * sel if out is None else out + pooled * sel
    return out
