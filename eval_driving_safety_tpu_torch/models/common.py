"""Shared building blocks: channel-last convs, dense layers, frozen
BatchNorm, max pooling, resizes.

Every public function takes and returns channel-last tensors, as the JAX
package's modules do. A conv permutes its NHWC input to an NCHW view,
which for a contiguous NHWC tensor is already in `channels_last` memory
format, so no copy is made on the way in or out.

Parameters are kept in float32 and cast to the module's compute dtype at
each use, as Flax modules with `dtype=bfloat16` do. Parameter names follow
the Flax model's auto-names (`Conv_0`, `FrozenBatchNorm_0`, ...), so
utils.from_flax maps weights leaf for leaf.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow/Flax "SAME" padding (low, high) of one axis: with stride
    2 and an even size it is (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Flax's default kernel init: truncated normal at +-2 std, scaled so
    the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Conv(nn.Module):
    """2D conv on NHWC. `padding` is "sym" (dilation * (k // 2) on every
    side, the JAX package's `conv()`) or "SAME" (Flax's stride-dependent
    padding, asymmetric for stride 2 on even sizes)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, padding="sym", bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.padding == "SAME":
            (t, b), (l, r) = (same_pads(x.shape[2], self.kernel, self.stride),
                              same_pads(x.shape[3], self.kernel, self.stride))
        else:
            t = b = l = r = self.dilation * (self.kernel // 2)
        if (t, l) == (b, r):
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad,
                     self.dilation)
        return y.permute(0, 2, 3, 1).contiguous()


class Dense(nn.Module):
    """Flax's `nn.Dense` on the last axis; `weight` is (out, in), the
    transposed Flax kernel."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class ConvTranspose(nn.Module):
    """Flax's `nn.ConvTranspose(features, (k, k), strides=(k, k))` (SAME
    padding, `transpose_kernel=False`) on NHWC: out[k*i + a] = x[i] *
    kernel[k - 1 - a]. Flax does not flip its kernel where
    `conv_transpose2d` does, so `weight` (in, out, k, k) holds the Flax
    kernel flipped in both spatial axes (utils.from_flax flips it)."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel = kernel
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        y = F.conv_transpose2d(x, self.weight.to(self.dtype),
                               self.bias.to(self.dtype), stride=self.kernel)
        return y.permute(0, 2, 3, 1).contiguous()


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int) -> torch.Tensor:
    """NHWC max pool with `padding` rows and columns of -inf on every side
    (Flax's `nn.max_pool` with explicit padding ((p, p), (p, p)))."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def cast_matmul_params(model: nn.Module,
                       dtype=torch.bfloat16) -> nn.Module:
    """Cast every float32 parameter of rank >= 2 (conv and dense kernels)
    to `dtype` once, in place; 1-D parameters (biases, BatchNorm
    statistics) stay float32. The modules cast their weights to the
    compute dtype at each use, so the computation is the same and the
    casts are not repeated every iteration."""
    for p in model.parameters():
        if p.dim() >= 2 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: y = (x - mean) / sqrt(var + eps) * scale + bias,
    with the statistics as plain parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.reciprocal(torch.sqrt(self.var + self.eps))
        inv = (self.scale * r).to(x.dtype)
        b = (self.bias - self.mean * self.scale * r).to(x.dtype)
        return x * inv + b

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inv, off) in float32, as the fused depth stage folds them."""
        inv = self.scale * torch.reciprocal(torch.sqrt(self.var + self.eps))
        return inv, self.bias - self.mean * inv


class ConvBnRelu(nn.Module):
    """Conv (symmetric padding dilation * (k // 2)) + FrozenBatchNorm +
    optional ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, relu: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, dilation,
                           dtype=dtype)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.FrozenBatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.relu else x


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """(n_out, n_in) float32 weights of a 1D linear resize with half-pixel
    centers, antialiased when it shrinks: the weights F.interpolate uses,
    read off by resizing the identity on the CPU (along the last axis:
    the CPU's antialiased resize of an (n, 1) image gives wrong values).
    Made outside inference mode: the cached matrix also serves calls
    whose gradient autograd records."""
    with torch.inference_mode(False):
        eye = torch.eye(n_in).reshape(n_in, 1, 1, n_in)
        cols = F.interpolate(eye, size=(1, n_out), mode="bilinear",
                             align_corners=False, antialias=n_out < n_in)
        return cols[:, 0, 0, :].t().contiguous().to(device)


def _resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    if x.shape[axis] == n_out:
        return x
    m = resize_matrix(x.shape[axis], n_out, str(x.device)).to(x.dtype)
    return torch.movedim(torch.movedim(x, axis, -1) @ m.t(), -1, axis)


# Resizes are separable matrix products rather than F.interpolate, whose
# CUDA backward accumulates with atomics in no fixed order: with products
# the attack's gradients, and so its iterates, repeat bit for bit.

def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC linear resize matching `jax.image.resize(..., "linear")`, which
    antialiases when it shrinks an axis (and, upsampling, the JAX
    package's `upsample_bilinear`). A shrinking resize runs in f32
    and returns x's dtype."""
    shrink = out_h < x.shape[1] or out_w < x.shape[2]
    y = x.float() if shrink else x
    y = _resize_axis(_resize_axis(y, 1, out_h), 2, out_w)
    return y.to(x.dtype).contiguous()


def resize_trilinear(x: torch.Tensor, size: Sequence[int],
                     shard=None) -> torch.Tensor:
    """(N, D, H, W, C) trilinear upsample to (D', H', W'), matching
    `jax.image.resize(..., "linear")` when no axis shrinks.

    With `shard` (a parallel.volume.VolumeShard) x holds this model
    rank's planes of a volume split evenly by depth plane, and D' is the
    rank's planes of the result: the whole upsample's planes there, read
    from a halo of one plane on each side (the volume's edge behaviour
    stays at its ends)."""
    if any(s < n for s, n in zip(size, x.shape[1:4])):
        raise ValueError("resize_trilinear only upsamples")
    if shard is not None:
        x = _resize_planes(x, size[0], shard)
    for axis, n in zip((1, 2, 3), size):
        x = _resize_axis(x, axis, n)
    return x.contiguous()


@functools.lru_cache(maxsize=None)
def _plane_window(k_in: int, k_out: int, n: int, rank: int,
                  device: str) -> torch.Tensor:
    """(k_out, k_in + 2) weights of model rank `rank`'s output planes of
    the whole (n k_in -> n k_out) resize over its planes and one halo
    plane on each side; raises if a weight falls outside that window."""
    with torch.inference_mode(False):
        m = resize_matrix(k_in * n, k_out * n, "cpu")
        rows = m[rank * k_out:(rank + 1) * k_out]
        cols = torch.arange(rank * k_in - 1, (rank + 1) * k_in + 1)
        inside = (cols >= 0) & (cols < k_in * n)
        window = torch.zeros(k_out, k_in + 2)
        window[:, inside] = rows[:, cols[inside]]
        if float(rows.abs().sum() - window.abs().sum()) != 0.0:
            raise ValueError(f"a resize of {k_in * n} -> {k_out * n} planes "
                             "reads more than one plane past a rank's")
        return window.to(device)


def _resize_planes(x: torch.Tensor, k_out: int, shard) -> torch.Tensor:
    from eval_driving_safety_tpu_torch.parallel.volume import halo_exchange
    k_in = x.shape[1]
    if k_in == k_out:
        return x
    m = _plane_window(k_in, k_out, shard.n, shard.rank,
                      str(x.device)).to(x.dtype)
    xe = halo_exchange(x, shard, 1, 1)
    return torch.movedim(torch.movedim(xe, 1, -1) @ m.t(), -1, 1)
