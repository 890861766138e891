"""Fused depth stage of the (2+1)D volume convs on the card
(csrc/depth_tap_conv.cu).

Counterpart of eval_driving_safety_tpu/ops/pallas_depthconv.py: a 3-tap
conv over D of a channel-last (B, D, H, W, C) volume, times the folded
frozen-BatchNorm coefficients, plus an optional ReLU:

    y[d] = act((x[d-1] W0 + x[d] W1 + x[d+1] W2) * inv + off)

with f32 accumulation and the result in x's dtype. W is (3, C, F), the
`nn.Conv(F, (3,))` kernel layout of the Flax model. The kernels take
every depth D (1 and 2 included) and C, F in {8, 16, 32, 64}.
`reference_depth_tap_conv` is the plain PyTorch version, used for CPU
tensors and as the kernels' yardstick. A CUDA tensor goes through the
kernels or the call raises.

bf16 (the attack path) runs the forward and dx on tensor cores
(mma.sync fed by cp.async, one block walking the planes of a pixel
tile); dx forms dz = bf16(dy * 1[y > 0] * inv) as the TPU kernel does,
one rounding more than the plain version, which keeps dz in f32. fp32
runs on CUDA-core f32 FMAs, so the tiny model matches the CPU closely.
The bf16 kernels copy 16-byte chunks, so a bf16 input whose view starts
off a 16-byte boundary is first copied (counted in `_cuda.align_copies`;
the model's inputs never need it).

The backward always computes dx; dW and the coefficient gradients
(one more kernel, f32 FMAs in both dtypes, reduced over the whole grid
with f32 atomics) run only when autograd asks for them, which the
attack never does. The dx and the dW kernel each count as one launch
of `depth_tap_conv_bwd`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from eval_driving_safety_tpu_torch.ops import _cuda

CHANNELS = (8, 16, 32, 64)


def _aligned(t):
    """t, or, for the bf16 kernels' 16-byte copies, a copy of it where its
    data does not start on 16 bytes; `_cuda.align_copies` counts each."""
    if t.dtype != torch.bfloat16 or t.data_ptr() % 16 == 0:
        return t
    _cuda.align_copies["depth_tap_conv"] += 1
    return t.clone()


def reference_depth_tap_conv(x5, w, inv, off, relu: bool = True):
    """Plain version: (B, D, H, W, C) -> (B, D, H, W, F)."""
    xf = x5.float()
    wf = w.to(x5.dtype).float()
    z = torch.einsum("bdhwc,cf->bdhwf", xf, wf[1])
    # tap 0 reads plane d-1 (zero at d = 0), tap 2 plane d+1 (zero at D-1)
    z = z + F.pad(torch.einsum("bdhwc,cf->bdhwf", xf[:, :-1], wf[0]),
                  (0, 0, 0, 0, 0, 0, 1, 0))
    z = z + F.pad(torch.einsum("bdhwc,cf->bdhwf", xf[:, 1:], wf[2]),
                  (0, 0, 0, 0, 0, 0, 0, 1))
    out = z * inv.float() + off.float()
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x5.dtype)


class _DepthTapConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x4, w, inv, off, relu):
        b, d, n, c = x4.shape
        f = w.shape[-1]
        _cuda.check_tensors("depth_tap_conv", x4, w, inv, off)
        if c not in CHANNELS or f not in CHANNELS:
            raise ValueError(f"depth_tap_conv: C={c}, F={f}; the kernels "
                             f"take channel counts in {CHANNELS}")
        if w.shape != (3, c, f) or inv.shape != (f,) or off.shape != (f,):
            raise ValueError("depth_tap_conv: w must be (3, C, F) and "
                             "inv/off (F,)")
        y = torch.empty((b, d, n, f), dtype=x4.dtype, device=x4.device)
        _cuda.launch("depth_tap_conv", "dtc_forward",
                     _cuda.DTYPE_CODES[x4.dtype], x4.data_ptr(),
                     w.data_ptr(), inv.data_ptr(), off.data_ptr(),
                     y.data_ptr(), b, d, n, c, f, int(relu))
        _cuda.count_launch("depth_tap_conv_fwd", (b, d, n, c, f), x4.dtype)
        ctx.save_for_backward(x4, w, inv, y)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x4, w, inv, y = ctx.saved_tensors
        b, d, n, c = x4.shape
        f = w.shape[-1]
        dy = _aligned(dy.contiguous())
        code = _cuda.DTYPE_CODES[x4.dtype]
        need_x, need_w, need_inv, need_off = ctx.needs_input_grad[:4]
        dx = dw = dinv = doff = None
        if need_x:
            dx = torch.empty_like(x4)
            _cuda.launch("depth_tap_conv", "dtc_backward_dx", code,
                         y.data_ptr(), dy.data_ptr(), w.data_ptr(),
                         inv.data_ptr(), dx.data_ptr(), b, d, n, c, f,
                         int(ctx.relu))
            _cuda.count_launch("depth_tap_conv_bwd", (b, d, n, c, f),
                               x4.dtype)
        if need_w or need_inv or need_off:
            dw32 = torch.empty((3, c, f), dtype=torch.float32,
                               device=x4.device)
            dco = torch.empty((2, f), dtype=torch.float32, device=x4.device)
            _cuda.launch("depth_tap_conv", "dtc_backward_w", code,
                         x4.data_ptr(), y.data_ptr(), dy.data_ptr(),
                         w.data_ptr(), inv.data_ptr(), dw32.data_ptr(),
                         dco.data_ptr(), b, d, n, c, f, int(ctx.relu))
            _cuda.count_launch("depth_tap_conv_bwd", (b, d, n, c, f),
                               x4.dtype)
            dw = dw32.to(w.dtype)
            dinv, doff = dco[0].to(inv.dtype), dco[1].to(inv.dtype)
        return dx, dw, dinv, doff, None


def depth_tap_conv(x5, w, inv, off, relu: bool = True):
    """Fused depth-tap conv + affine + optional ReLU on (B, D, H, W, C).

    w: (3, C, F); inv/off: (F,) folded FrozenBatchNorm coefficients. On
    the card w, inv and off are cast to x's dtype first, as the TPU path
    casts them."""
    if x5.device.type == "cpu":
        return reference_depth_tap_conv(x5, w, inv, off, relu)
    if x5.device.type != "cuda":
        raise ValueError(f"depth_tap_conv: unsupported device {x5.device}")
    b, d, h, wd, c = x5.shape
    y = _DepthTapConv.apply(_aligned(x5.reshape(b, d, h * wd, c)),
                            _aligned(w.to(x5.dtype).contiguous()),
                            inv.to(x5.dtype).contiguous(),
                            off.to(x5.dtype).contiguous(), bool(relu))
    return y.reshape(b, d, h, wd, w.shape[-1])
