"""Plane-sweep-volume disparity warp on the card (csrc/psv_warp.cu).

Counterpart of eval_driving_safety_tpu/ops/pallas_psv.py. For every depth
plane d the right-view features are sampled at x - disp_d (sub-pixel,
zero outside the row, zero where x - disp_d leaves [0, W-1]). The kernel
pair computes the same function as the TPU's `_fwd_kernel`/`_bwd_kernel`
with the same split of each disparity into a whole shift k_d =
clip(floor(disp_d), 0, W-1) and a fraction f_d = disp_d - k_d;
`cost_volume.shift_along_width` is that arithmetic in plain PyTorch, used
for CPU tensors and as the kernels' yardstick. A CUDA tensor goes through
the kernels or the call raises.

`build_psv` fuses the concatenation: on the card one kernel writes the
whole (B, D, H, W, 2C) volume, left features tiled over D in the left
half, and the backward kernel returns both feature gradients.
"""
from __future__ import annotations

import torch

from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.cost_volume import shift_along_width


class _PSVWarp(torch.autograd.Function):
    """Warp (and, with `fl`, the fused PSV) through the CUDA kernels."""

    @staticmethod
    def forward(ctx, fr, disps, fl):
        b, h, w, c = fr.shape
        d = disps.shape[1]
        fused = fl is not None
        _cuda.check_tensors("psv_warp", fr, *((fl,) if fused else ()))
        if disps.dtype != torch.float32 or not disps.is_cuda \
                or disps.shape != (b, d) or not disps.is_contiguous():
            raise ValueError("psv_warp: disps must be a contiguous (B, D) "
                             "float32 CUDA tensor")
        if fused and fl.shape != fr.shape:
            raise ValueError(f"psv_warp: fl {tuple(fl.shape)} != fr "
                             f"{tuple(fr.shape)}")
        out = torch.empty((b, d, h, w, 2 * c if fused else c),
                          dtype=fr.dtype, device=fr.device)
        _cuda.launch("psv_warp", "psv_warp_forward",
                     _cuda.DTYPE_CODES[fr.dtype], fr.data_ptr(),
                     fl.data_ptr() if fused else None, disps.data_ptr(),
                     out.data_ptr(), b, d, h, w, c)
        _cuda.count_launch("psv_warp_fwd", (b, d, h, w, c), fr.dtype)
        ctx.save_for_backward(disps)
        ctx.fused = fused
        ctx.shape = fr.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (disps,) = ctx.saved_tensors
        b, h, w, c = ctx.shape
        g = g.contiguous()
        gfr = torch.empty(ctx.shape, dtype=g.dtype, device=g.device)
        gfl = torch.empty_like(gfr) if ctx.fused else None
        _cuda.launch("psv_warp", "psv_warp_backward",
                     _cuda.DTYPE_CODES[g.dtype], g.data_ptr(),
                     disps.data_ptr(), gfr.data_ptr(),
                     gfl.data_ptr() if ctx.fused else None,
                     b, disps.shape[1], h, w, c)
        _cuda.count_launch("psv_warp_bwd", (b, disps.shape[1], h, w, c),
                           g.dtype)
        return gfr, None, gfl


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"psv_warp: unsupported device {t.device}")
    return t.device.type


def psv_warp(fr: torch.Tensor, disps: torch.Tensor) -> torch.Tensor:
    """fr (B, H, W, C), disps (B, D) f32 -> warped (B, D, H, W, C)."""
    if _route(fr) == "cpu":
        return shift_along_width(fr, disps)
    return _PSVWarp.apply(fr, disps, None)


def plane_disparities(f_u, baseline, planes, stride: int) -> torch.Tensor:
    """(B, D) disparities in feature pixels, f*b/z/stride, evaluated in
    the inputs' dtype (bf16 rounding included when the model runs in bf16,
    as in the JAX model) and returned as f32."""
    return (f_u[:, None] * baseline[:, None] / planes[None, :]
            / stride).float()


def build_psv(feat_left, feat_right, f_u, baseline, planes,
              stride: int) -> torch.Tensor:
    """(B, H, W, C) stride-`stride` features -> PSV (B, D, H, W, 2C): left
    features tiled over D, right features warped by each plane's
    disparity. Counterpart of `build_psv_pallas`."""
    disps = plane_disparities(f_u, baseline, planes, stride).contiguous()
    if _route(feat_right) == "cpu":
        d = disps.shape[1]
        tiled = feat_left[:, None].expand(-1, d, -1, -1, -1)
        return torch.cat([tiled, shift_along_width(feat_right, disps)],
                         dim=-1)
    return _PSVWarp.apply(feat_right, disps, feat_left)
