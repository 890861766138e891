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

The kernels move every pixel's channels in accesses of 16 bytes where C
and the tensors' start addresses allow it, else of 8, 4 or 2
(`vector_bytes`; the result is the same bit for bit), so no input is
copied to meet an alignment. The width of each launch is recorded in
`_cuda.launch_widths`; the one copy the wrappers can make, of an upstream
gradient that is not contiguous, is counted in `_cuda.align_copies`.
"""
from __future__ import annotations

import torch

from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.cost_volume import shift_along_width


def vector_bytes(c: int, element_size: int, *pointers: int) -> int:
    """The widest access, 16, 8, 4 or 2 bytes, that holds whole elements
    and divides both a pixel's `c` channels and every pointer."""
    for width in (16, 8, 4, 2):
        if width >= element_size and (c * element_size) % width == 0 \
                and all(p % width == 0 for p in pointers):
            return width
    raise ValueError(f"psv_warp: no access width for C={c} of "
                     f"{element_size}-byte elements at {pointers}")


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy of it, counted in `_cuda.align_copies`."""
    if t.is_contiguous():
        return t
    _cuda.align_copies["psv_warp"] += 1
    return t.contiguous()


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
        ptrs = [t.data_ptr() for t in (fr, out, *((fl,) if fused else ()))]
        width = vector_bytes(c, fr.element_size(), *ptrs)
        _cuda.launch("psv_warp", "psv_warp_forward",
                     _cuda.DTYPE_CODES[fr.dtype], fr.data_ptr(),
                     fl.data_ptr() if fused else None, disps.data_ptr(),
                     out.data_ptr(), b, d, h, w, c, width)
        _cuda.count_launch("psv_warp_fwd", (b, d, h, w, c), fr.dtype, width)
        ctx.save_for_backward(disps)
        ctx.fused = fused
        ctx.shape = fr.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (disps,) = ctx.saved_tensors
        b, h, w, c = ctx.shape
        d = disps.shape[1]
        g = _contiguous(g)
        gfr = torch.empty(ctx.shape, dtype=g.dtype, device=g.device)
        gfl = torch.empty_like(gfr) if ctx.fused else None
        ptrs = [t.data_ptr() for t in (g, gfr, *((gfl,) if ctx.fused
                                                 else ()))]
        width = vector_bytes(c, g.element_size(), *ptrs)
        _cuda.launch("psv_warp", "psv_warp_backward",
                     _cuda.DTYPE_CODES[g.dtype], g.data_ptr(),
                     disps.data_ptr(), gfr.data_ptr(),
                     gfl.data_ptr() if ctx.fused else None,
                     b, d, h, w, c, width)
        _cuda.count_launch("psv_warp_bwd", (b, d, h, w, c), g.dtype, width)
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


def psv_from_disparities(feat_left, feat_right,
                         disps: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) features and (B, D) f32 disparities -> PSV (B, D, H, W,
    2C): left features tiled over D, right features warped by each
    plane's disparity."""
    if _route(feat_right) == "cpu":
        d = disps.shape[1]
        tiled = feat_left[:, None].expand(-1, d, -1, -1, -1)
        return torch.cat([tiled, shift_along_width(feat_right, disps)],
                         dim=-1)
    return _PSVWarp.apply(feat_right, disps, feat_left)


def build_psv(feat_left, feat_right, f_u, baseline, planes,
              stride: int) -> torch.Tensor:
    """(B, H, W, C) stride-`stride` features -> PSV (B, D, H, W, 2C) at the
    disparities of the plane depths `planes`. Counterpart of
    `build_psv_pallas`."""
    disps = plane_disparities(f_u, baseline, planes, stride).contiguous()
    return psv_from_disparities(feat_left, feat_right, disps)
