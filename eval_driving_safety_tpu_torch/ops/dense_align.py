"""Dense photometric stereo alignment: each detection's disparity refined
against the image pair.

Counterpart of eval_driving_safety_tpu/ops/dense_align.py. Every
detection samples a 24 x 24 grid over the lower half of its box (clipped
to its visible borders) in the left image, and the right image at the
same grid shifted by each of 64 candidate disparities around its
estimate (d0 + linspace(-8, 8)); the candidate of least photometric SSD
wins, the first one on ties. Samples shifted off the image cost 1e3
each. The whole batch of detections is one set of tensor ops on the
images' device: an (N, 64, 24, 24, 3) gather and a sum.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _bilinear(img: torch.Tensor, ys: torch.Tensor,
              xs: torch.Tensor) -> torch.Tensor:
    """img (H, W, 3); ys/xs of one shape -> (..., 3), coordinates clamped
    to the border."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0 = y0.long()
    x0 = x0.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    return (img[y0, x0] * ((1 - fy) * (1 - fx))[..., None]
            + img[y0, x1] * ((1 - fy) * fx)[..., None]
            + img[y1, x0] * (fy * (1 - fx))[..., None]
            + img[y1, x1] * (fy * fx)[..., None])


def candidate_errors(im_left: torch.Tensor, im_right: torch.Tensor,
                     boxes: torch.Tensor, borders: torch.Tensor,
                     init_disp: torch.Tensor, *, num_candidates: int = 64,
                     sweep_px: float = 8.0, grid: int = 24
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The photometric error of each detection's candidate disparities.

    im_left/im_right: (H, W, 3) float32 images (any consistent scale);
    boxes (N, 4) left boxes, borders (N, 2) the visible [left_u, right_u]
    span, init_disp (N,) the geometric estimates, all float32 on the
    images' device. Returns (success (N,) bool, candidates (N, C),
    errors (N, C)): success where the clipped box is wider and taller
    than 2 px and the estimate above 0.5."""
    dev = im_left.device
    # the candidates rounded once from f64, the same on every device
    cands = torch.from_numpy(np.linspace(-sweep_px, sweep_px, num_candidates)
                             .astype(np.float32)).to(dev)        # (C,)
    x1 = torch.maximum(boxes[:, 0], borders[:, 0])[:, None]      # (N, 1)
    x2 = torch.minimum(boxes[:, 2], borders[:, 1])[:, None]
    y1, y2 = boxes[:, 1:2], boxes[:, 3:4]
    # the lower half of the box: the body region
    ym = (y1 + y2) / 2.0
    t = torch.arange(grid, dtype=torch.float32, device=dev) + 0.5
    us = x1 + (x2 - x1) * t / grid                               # (N, P)
    vs = ym + (y2 - ym) * t / grid
    vv = vs[:, :, None].expand(-1, -1, grid)                     # (N, P, P)
    uu = us[:, None, :].expand(-1, grid, -1)
    left = _bilinear(im_left, vv, uu)                            # (N,P,P,3)
    disps = init_disp[:, None] + cands                           # (N, C)
    uu_r = uu[:, None] - disps[:, :, None, None]                 # (N,C,P,P)
    right = _bilinear(im_right, vv[:, None].expand_as(uu_r), uu_r)
    # samples shifted past the image edge would match the clamped border
    # pixels: they are penalized instead
    in_range = ((uu_r >= 0.0)
                & (uu_r <= im_right.shape[1] - 1.0))[..., None]
    sq = ((right - left[:, None]) ** 2) * in_range
    err = sq.sum(dim=(2, 3, 4)) \
        + 1e3 * (~in_range).sum(dim=(2, 3, 4)).to(sq.dtype)
    ok = (x2[:, 0] > x1[:, 0] + 2.0) & (y2[:, 0] > y1[:, 0] + 2.0) \
        & (init_disp > 0.5)
    return ok, disps, err


def align_disparities(im_left: torch.Tensor, im_right: torch.Tensor,
                      boxes: torch.Tensor, borders: torch.Tensor,
                      init_disp: torch.Tensor, **kw
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine N detections' disparities photometrically: the candidate of
    least error (`candidate_errors`, which takes the same arguments), the
    first one on ties, floored at 0.5. Returns (success (N,) bool,
    disparity (N,))."""
    ok, disps, err = candidate_errors(im_left, im_right, boxes, borders,
                                      init_disp, **kw)
    best = torch.argmin(err, dim=1)
    disp = torch.gather(disps, 1, best[:, None])[:, 0]
    return ok, torch.clamp(disp, min=0.5)
