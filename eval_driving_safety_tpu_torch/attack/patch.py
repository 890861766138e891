"""Universal circular adversarial patch: placement, compositing, the
training step and npy persistence.

Counterpart of eval_driving_safety_tpu/attack/patch.py:
* circular patch, diameter = short-side * ratio (made odd);
* random centre: row in [0.4*H, H-r-1], col in a band of the width, both
  bounds inclusive, drawn from a `torch.Generator`;
* the right-image centre shifted by the stereo disparity offset
  -40*1.6 = -64 px;
* composite img = (1-mask)*img + mask*patch, clipped at the image border;
* update patch <- patch - clamp(0.5*alpha*g, -eps, eps), g the loss's
  gradient with respect to the patch through both views' composites,
  summed over the batch's rows in their order (over every rank where the
  batch is split);
* patches persist as npy in the reference's (1, 3, d, d) layout, so they
  are interchangeable between the two packages; a patch of another size
  is resized as cv2's INTER_LINEAR resizes.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from eval_driving_safety_tpu_torch.parallel.sharding import (gather_rows,
                                                             global_sum)


def patch_dim_for(short_side: int, ratio: float) -> int:
    """Diameter = short_side * ratio, forced odd."""
    d = int(short_side * ratio)
    return d + 1 if d % 2 == 0 else d


@lru_cache(maxsize=8)
def _mask_np(dim: int) -> np.ndarray:
    r = dim // 2
    yy, xx = np.mgrid[:dim, :dim]
    return ((yy - r) ** 2 + (xx - r) ** 2 <= r * r).astype(np.float32)[..., None]


def circular_mask(dim: int, device=None) -> torch.Tensor:
    """(dim, dim, 1) float mask of the inscribed circle."""
    return torch.from_numpy(_mask_np(dim)).to(device)


def sample_patch_centers(gen: torch.Generator, batch: int, height: int,
                         width: int, radius: int, *, row_band=(0.4, 1.0),
                         col_band=(0.2, 0.8), disparity_shift: float = -64.0):
    """Per-image (row, col) centres of the left view and the shifted right
    view, (B, 2) int64 tensors on the CPU.

    row ~ randint[int(H*0.4), H-radius-1] and col ~ randint[int(W*lo),
    int(W*hi)], both INCLUSIVE of the upper bound (Python's random.randint),
    with no clamping: a large patch may cross the top edge and the right
    view's centre (col + shift) may lie past the left edge;
    `composite_patch` clips the circle at the border."""
    row_lo = int(height * row_band[0])
    row_hi = height - radius - 1                      # inclusive
    rows = torch.randint(row_lo, max(row_hi, row_lo) + 1, (batch,),
                         generator=gen)
    col_lo = int(width * col_band[0])
    col_hi = int(width * col_band[1])                 # inclusive
    cols = torch.randint(col_lo, max(col_hi, col_lo) + 1, (batch,),
                         generator=gen)
    cols_r = cols + int(disparity_shift)
    return torch.stack([rows, cols], -1), torch.stack([rows, cols_r], -1)


def composite_patch(img: torch.Tensor, patch: torch.Tensor,
                    center) -> torch.Tensor:
    """Composite one (d, d, 3) patch into one (H, W, 3) image at (row, col).

    A placement whose window crosses the border is clipped there (the part
    of the circle outside the image is dropped). The image is padded by
    2r, so every partly visible centre (in [-r, size-1+r]) maps to a
    window start `center + r` >= 0; a centre with no visible pixel leaves
    the image as it is. Starts are clamped as the JAX version's
    dynamic_slice clamps them."""
    d = patch.shape[0]
    r = d // 2
    h, w, c = img.shape
    row, col = int(center[0]), int(center[1])
    visible = -r <= row <= h - 1 + r and -r <= col <= w - 1 + r
    mask = circular_mask(d, img.device).to(img.dtype) * float(visible)
    padded = img.new_zeros((h + 4 * r, w + 4 * r, c))
    padded[2 * r:2 * r + h, 2 * r:2 * r + w] = img
    y0 = min(max(row + r, 0), h + 2 * r - 1)
    x0 = min(max(col + r, 0), w + 2 * r - 1)
    window = padded[y0:y0 + d, x0:x0 + d]
    merged = (1.0 - mask) * window + mask * patch.to(img.device, img.dtype)
    padded[y0:y0 + d, x0:x0 + d] = merged
    return padded[2 * r:2 * r + h, 2 * r:2 * r + w]


def composite_patch_batch(imgs: torch.Tensor, patch: torch.Tensor,
                          centers) -> torch.Tensor:
    """(B, H, W, 3) x (d, d, 3) x (B, 2) -> (B, H, W, 3)."""
    centers = np.asarray(torch.as_tensor(centers).cpu())
    return torch.stack([composite_patch(im, patch, ctr)
                        for im, ctr in zip(imgs, centers)])


def patch_update_step(loss_fn: Callable, patch: torch.Tensor, imgs_left,
                      imgs_right, centers_left, centers_right, *,
                      alpha: float, eps: float, pixel_min=None,
                      pixel_max=None):
    """One universal-patch descent step over a batch.

    loss_fn(imL, imR) -> scalar (the detector's loss toward the targeted
    labels, which the patch descends). The gradient reaches the patch
    through both views' composites. Each row's gradient is taken on its
    own, and the rows' gradients are added in the global batch's row
    order: where the batch is split over ranks (`parallel.sharding`),
    they are gathered from every rank first, so each rank holds the patch
    of one process bit for bit. Returns (new patch, detached; the whole
    batch's loss, detached)."""
    rows = [patch.detach().clone().requires_grad_(True)
            for _ in range(len(imgs_left))]

    def composite(imgs, centers):
        centers = np.asarray(torch.as_tensor(centers).cpu())
        return torch.stack([composite_patch(im, p, ctr)
                            for im, p, ctr in zip(imgs, rows, centers)])
    loss = loss_fn(composite(imgs_left, centers_left),
                   composite(imgs_right, centers_right))
    grads = gather_rows(torch.stack(torch.autograd.grad(loss, rows)))
    g = grads[0]
    for row in grads[1:]:
        g = g + row
    new_patch = patch.detach() - torch.clamp(0.5 * alpha * g, -eps, eps)
    if pixel_min is not None:
        new_patch = torch.clamp(new_patch, pixel_min, pixel_max)
    return new_patch, global_sum(loss.detach())


def init_patch(short_side: int, ratio: float, save_dir: str = None):
    """A fresh zero patch, written as `save_dir/epoch0/patch.npy`, or the
    patch found there, resized to the diameter. Returns (dim, radius,
    patch (d, d, 3) float32 CPU tensor)."""
    dim = patch_dim_for(short_side, ratio)
    if save_dir is not None:
        p0 = os.path.join(save_dir, "epoch0", "patch.npy")
        if os.path.exists(p0):
            return dim, dim // 2, load_patch(p0, resize_to=dim)
        os.makedirs(os.path.dirname(p0), exist_ok=True)
        np.save(p0, np.zeros((1, 3, dim, dim), np.float32))
    return dim, dim // 2, torch.zeros((dim, dim, 3), dtype=torch.float32)


def save_patch(path: str, patch) -> None:
    """(d, d, 3) -> npy in the reference's (1, 3, d, d) layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(torch.as_tensor(patch).detach().cpu())
    np.save(path, arr.transpose(2, 0, 1)[None].astype(np.float32))


def _inter_linear_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) float64 weights of cv2's INTER_LINEAR along one
    axis: two taps at half-pixel centres, no antialiasing when it
    shrinks, a source coordinate below 0 taking row 0 and one past the
    end the last row."""
    f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    frac[i0 < 0] = 0.0
    i0 = np.clip(i0, 0, n_src - 1)
    i1 = np.minimum(i0 + 1, n_src - 1)
    m = np.zeros((n_dst, n_src))
    rows = np.arange(n_dst)
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i1), frac)
    return m


def load_patch(path: str, resize_to: int = None) -> torch.Tensor:
    """npy (1, 3, d, d) -> (d, d, 3) float32 CPU tensor, optionally
    resized to `resize_to` pixels as cv2.resize(..., INTER_LINEAR) does
    (the reference's ingest of a patch trained at another size)."""
    arr = np.load(path)[0].transpose(1, 2, 0)
    if resize_to is not None and arr.shape[0] != resize_to:
        my = _inter_linear_matrix(arr.shape[0], resize_to)
        mx = _inter_linear_matrix(arr.shape[1], resize_to)
        arr = np.einsum("yi,ijc,xj->yxc", my, arr.astype(np.float64), mx)
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
