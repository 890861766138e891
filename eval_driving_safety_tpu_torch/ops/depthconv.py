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
(the fp32 card-vs-CPU checks) runs the forward and dx on CUDA-core f32
FMAs, TF32 nowhere: one kernel walks a run of planes of a pixel tile
through a cp.async ring, each thread holding three output planes'
accumulators, so each staged plane is read once; dx forms dz = dy *
1[y > 0] * inv in f32. Every output is summed in one fixed order, so
two calls give the same bits. The kernels copy 16-byte chunks, so an
input whose view starts off a 16-byte boundary is first copied (counted
in `_cuda.align_copies`; the model's inputs never need it).

The backward always computes dx; dW and the coefficient gradients run
only when autograd asks for them, which the attack never does and
training always does. In bf16 they come from one split-K tensor-core
GEMM, G = sum A_d^T dm[d] with A_d = [x[d-1] | x[d] | x[d+1]], whose
slices' f32 partials (a workspace the wrapper allocates,
`wgrad_workspace_bytes`) a second kernel sums in a fixed order: dW =
inv G, d inv = sum W G, d off = sum dm, the same bits on every run
(`reference_depth_tap_conv_wgrad` is its plain version, for the tests).
In fp32 one CUDA-core kernel recomputes z and sums with f32 atomics. The
dx kernel counts as a launch of `depth_tap_conv_bwd`, the weight
gradient as one of `depth_tap_conv_wgrad`.

On the model axis (parallel/volume.py) a rank holds D_local planes of the
volume: `depth_tap_conv_planes` runs the same kernels on them with a halo
of one plane on each side (D_local + 2 planes; zero planes at the
volume's ends are the kernel's own zero padding) and keeps the middle
D_local output planes. K4 dx computes the halo planes' dx too, which the
exchange's backward returns to the ranks that own them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from eval_driving_safety_tpu_torch.ops import _cuda

CHANNELS = (8, 16, 32, 64)


def _aligned(t):
    """t, or, for the kernels' 16-byte copies, a copy of it where its data
    does not start on 16 bytes; `_cuda.align_copies` counts each."""
    if t.data_ptr() % 16 == 0:
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
        # relu's gradient is 0 at 0, as the kernel's 1[y > 0] and JAX's
        # relu; clamp_min's passes there
        out = torch.relu(out)
    return out.to(x5.dtype)


def reference_depth_tap_conv_wgrad(x4, y, dy, w, inv, relu: bool = True):
    """Plain version of the weight gradient, computed as the bf16 kernels
    compute it: x4 (B, D, N, C), y and dy (B, D, N, F) -> dW (3, C, F),
    d inv (F,), d off (F,), all f32.

    With dm = dy * 1[y > 0] (exact in the inputs' dtype) and A_d =
    [x[d-1] | x[d] | x[d+1]] (zero outside [0, D)), one product
    G = sum_{b,d} A_d^T dm[d] gives every output: dW_t = inv * G_t,
    d inv = sum_{t,c} W_t * G_t (since sum dm z = sum dm sum_t x W_t) and
    d off = sum dm. Nothing is divided by inv."""
    xf = x4.float()
    dm = (torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy).float()
    g = torch.stack([
        # tap t pairs plane d + t - 1 of x with plane d of dm
        torch.einsum("bdnc,bdnf->cf", xf[:, :-1], dm[:, 1:]),
        torch.einsum("bdnc,bdnf->cf", xf, dm),
        torch.einsum("bdnc,bdnf->cf", xf[:, 1:], dm[:, :-1])])
    dw = g * inv.float()
    dinv = (w.float() * g).sum(dim=(0, 1))
    return dw, dinv, dm.sum(dim=(0, 1, 2))


def f32_geometry(b, d, n, c, f, dx=False):
    """(pixel tile, blocks) of the fp32 forward's (or dx's) launch at
    (B, D, N, C, F): the launch cuts B x tiles x D items into one equal
    contiguous run a block. For the checks at the kernels' edges."""
    tile, blocks = (_cuda.query("depth_tap_conv", "dtc_f32_geometry", what,
                                int(dx), b, d, n, c, f) for what in (0, 1))
    if tile < 0 or blocks < 0:
        raise ValueError(f"depth_tap_conv: C={c}, F={f}; the kernels take "
                         f"channel counts in {CHANNELS}")
    return tile, blocks


def wgrad_workspace_bytes(b, d, n, c, f) -> int:
    """Bytes of f32 workspace the bf16 weight gradient takes at (B, D, N,
    C, F): one (F, 3C + 1) partial per slice of its split-K GEMM."""
    nbytes = _cuda.query("depth_tap_conv", "dtc_wgrad_workspace_bytes",
                         b, d, n, c, f)
    if nbytes < 0:
        raise ValueError(f"depth_tap_conv: C={c}, F={f}; the kernels take "
                         f"channel counts in {CHANNELS}")
    return nbytes


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
            ws = None
            if x4.dtype == torch.bfloat16:
                ws = torch.empty(wgrad_workspace_bytes(b, d, n, c, f) // 4,
                                 dtype=torch.float32, device=x4.device)
            _cuda.launch("depth_tap_conv", "dtc_backward_w", code,
                         x4.data_ptr(), y.data_ptr(), dy.data_ptr(),
                         w.data_ptr(), inv.data_ptr(), dw32.data_ptr(),
                         dco.data_ptr(), None if ws is None else ws.data_ptr(),
                         b, d, n, c, f, int(ctx.relu))
            _cuda.count_launch("depth_tap_conv_wgrad", (b, d, n, c, f),
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


def depth_tap_conv_planes(x5, w, inv, off, relu: bool, shard):
    """`depth_tap_conv` on this model rank's planes of a volume split by
    depth plane (`shard`, a parallel.volume.VolumeShard): the rank's
    part of the whole volume's result."""
    from eval_driving_safety_tpu_torch.parallel.volume import halo_exchange
    y = depth_tap_conv(halo_exchange(x5, shard, 1, 1), w, inv, off, relu)
    return y[:, 1:-1]
