"""Stereo cost-volume ops: plane depths, the plain PSV warp (the CUDA
warp's version for CPU tensors and its yardstick), soft-argmin depth and
the 3D geometric volume (3DGV) resample.

Counterpart of eval_driving_safety_tpu/ops/cost_volume.py. Volumes are
channel-last: PSV (B, D, H, W, C), voxels (B, Z, Y, X, C). The 3DGV
resample is the JAX package's separable form (a depth lerp, then one
row and one column interpolation matrix per voxel slice), computed with
`torch.einsum`; it is a plain product outside any kernel. On the model
axis each rank resamples the voxel slices of its own planes.
"""
from __future__ import annotations

import numpy as np
import torch


def depth_planes(min_depth: float, max_depth: float, num: int,
                 device=None) -> torch.Tensor:
    """Plane depths, uniform in depth, float32."""
    return torch.linspace(min_depth, max_depth, num, dtype=torch.float32,
                          device=device)


def shift_along_width(feat: torch.Tensor, disps: torch.Tensor) -> torch.Tensor:
    """The plain PSV warp: sample `feat` (B, H, W, C) at x - disp for each
    of the (B, D) f32 disparities (sub-pixel, zero where x - disp leaves
    [0, W-1]) -> (B, D, H, W, C), computed in f32 and returned in feat's
    dtype. Each disparity splits as the kernels split it: a whole shift
    k = clip(floor(disp), 0, W-1) and a fraction f = disp - k."""
    b, h, w, c = feat.shape
    k = torch.clamp(torch.floor(disps), 0.0, w - 1.0)
    f = (disps - k)[:, :, None, None, None]               # (B, D, 1, 1, 1)
    xs = torch.arange(w, device=feat.device)
    xa = xs - k.long()[..., None]                         # (B, D, W)
    ft = feat.float().permute(0, 2, 1, 3)                 # (B, W, H, C)
    bi = torch.arange(b, device=feat.device)[:, None, None]

    def tap(idx):                                         # feat[b, h, idx, c]
        v = ft[bi, idx.clamp(0, w - 1)].permute(0, 1, 3, 2, 4)
        return v * ((idx >= 0) & (idx < w))[:, :, None, :, None]

    out = (1.0 - f) * tap(xa) + f * tap(xa - 1)
    xm = xs.float()[None, None, :] - disps[..., None]     # (B, D, W)
    valid = (xm >= 0.0) & (xm <= w - 1.0)
    return (out * valid[:, :, None, :, None]).to(feat.dtype)


def tent_weights(dst_coords: torch.Tensor, src_len: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Linear-interpolation matrix W[..., i, j] = tent(j - coord_i), zero
    where coord_i is outside [0, src_len-1]: (..., N) -> (..., N, src_len)."""
    src = torch.arange(src_len, dtype=dst_coords.dtype,
                       device=dst_coords.device)
    diff = src - dst_coords[..., None]
    w = torch.clamp_min(1.0 - torch.abs(diff), 0.0)
    valid = ((dst_coords >= 0.0) & (dst_coords <= src_len - 1.0))[..., None]
    return (w * valid).to(dtype)


def soft_argmin_depth(cost: torch.Tensor,
                      planes: torch.Tensor) -> torch.Tensor:
    """cost (B, D, H, W), higher = better -> (B, H, W) expected depth."""
    prob = torch.softmax(cost, dim=1)
    return torch.einsum("bdhw,d->bhw", prob, planes)


def psv_to_3dgv(vol, planes, calib_fu, calib_cu, calib_cv, cfg,
                stride: int, shard=None) -> torch.Tensor:
    """Resample frustum features (B, D, Hf, Wf, C) into the voxel grid
    (B, Z, Y, X, C) by pinhole projection per image: voxel (x, y, z) reads
    u = f x / z + cu, v = f y / z + cv (over `stride` for feature
    pixels) at the fractional plane index of z.

    With `shard` (a parallel.volume.VolumeShard) `vol` holds this model
    rank's planes [lo, hi) of the volume, and `planes` all D plane depths.
    The rank computes the voxel slices z whose lerp reads planes
    floor(di) and floor(di) + 1 with floor(di) in [lo, hi) (clamped to the
    volume; the slices outside it are zero), from its planes and a halo of
    one plane above them, and the slices of every rank are gathered along
    Z: each slice is computed as one process computes it, and the result
    is the whole grid on every model rank."""
    d = planes.shape[0]
    dev, dtype = vol.device, vol.dtype
    zs_np = np.linspace(cfg.voxel_z_min, cfg.voxel_z_max, cfg.num_voxels_z)
    ys_np = np.linspace(cfg.voxel_y_min, cfg.voxel_y_max, cfg.num_voxels_y)
    xs_np = np.linspace(cfg.voxel_x_min, cfg.voxel_x_max, cfg.num_voxels_x)
    z0 = float(cfg.min_depth)
    dz = (float(cfg.max_depth) - float(cfg.min_depth)) / (d - 1)
    di_np = ((zs_np - z0) / dz).astype(np.float32)
    if shard is not None:
        from eval_driving_safety_tpu_torch.parallel.volume import (
            gather_planes, halo_exchange)
        lo, hi = shard.planes(d)
        owner = np.clip(np.floor(di_np), 0, d - 1).astype(np.int64) // (
            hi - lo)
        sizes = [int((owner == r).sum()) for r in range(shard.n)]
        first = sum(sizes[:shard.rank])
        mine = slice(first, first + sizes[shard.rank])
        zs_np, di_np = zs_np[mine], di_np[mine]
        vol = halo_exchange(vol, shard, 0, 1)
    di = torch.as_tensor(di_np, device=dev)
    zs = torch.as_tensor(zs_np, dtype=torch.float32, device=dev)
    ys = torch.as_tensor(ys_np, dtype=torch.float32, device=dev)
    xs = torch.as_tensor(xs_np, dtype=torch.float32, device=dev)

    wd = tent_weights(di, d, dtype=dtype)                         # (Z, D)
    if shard is not None:
        # the rank's planes and the halo plane (a zero column past D)
        wd = torch.nn.functional.pad(wd, (0, 1))[:, lo:hi + 1]
    mid = torch.einsum("zd,bdhwc->bzhwc", wd, vol)
    fu = calib_fu.float()[:, None, None]
    v = (fu * ys[None, None, :] / zs[None, :, None]
         + calib_cv.float()[:, None, None]) / stride              # (B, Z, Y)
    u = (fu * xs[None, None, :] / zs[None, :, None]
         + calib_cu.float()[:, None, None]) / stride              # (B, Z, X)
    wv = tent_weights(v, vol.shape[2], dtype=dtype)               # (B,Z,Y,H)
    wu = tent_weights(u, vol.shape[3], dtype=dtype)               # (B,Z,X,W)
    rows = torch.einsum("bzyh,bzhwc->bzywc", wv, mid)
    out = torch.einsum("bzxw,bzywc->bzyxc", wu, rows)
    if shard is not None:
        out = gather_planes(out, shard, sizes)
    return out
