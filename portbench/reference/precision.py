"""What a reference computes its products in. `exact` leaves float32
alone; `fp8` is the control: every conv and matmul operand rounded to
float8 e4m3 with a per-tensor scale on the way in, and every gradient
that flows back into one rounded to float8 e5m2; `bf16` rounds both to
bfloat16."""
from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = amax / top
    return ((x.float() / s).to(dtype).float() * s).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


class _BF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """The configuration's own precision, for a second witness: operands
    and the gradients into them rounded to bfloat16."""
    return _BF16.apply(x)


CASTS = {"float32": exact, "fp8": fp8, "bf16": bf16}
