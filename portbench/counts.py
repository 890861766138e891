"""The yardstick's arithmetic: the card's published peaks, the depth-tap
conv's bytes and operations per call (copied from the port's chip check,
`chip_smoke.py::check_depthconv`), and a model's operations per call
counted on the plain reference."""
from __future__ import annotations

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def depth_tap_conv_fwd(b, d, n, c, f, itemsize):
    """(bytes, operations) of the forward: x read and y written once,
    W, inv, off once; 3 taps of a C x F product per output pixel."""
    vol_in, vol_out = b * d * n * c, b * d * n * f
    small = (3 * c * f + 2 * f) * itemsize
    return (vol_in + vol_out) * itemsize + small, 2 * 3 * c * f * b * d * n


def depth_tap_conv_dx(b, d, n, c, f, itemsize):
    """(bytes, operations) of dx: reads y and dy, writes dx."""
    vol_in, vol_out = b * d * n * c, b * d * n * f
    small = (3 * c * f + 2 * f) * itemsize
    return (2 * vol_out + vol_in) * itemsize + small, 2 * 3 * c * f * b * d * n


def bound_s(nbytes, ops, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory's peak and the operations at the dtype's peak."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype])


def depth_tap_conv_bound_s(calls) -> float:
    """Summed bound of recorded calls (shape (B, D, N, C, F), dtype name,
    whether its dx ran)."""
    total = 0.0
    for shape, dtype, backward in calls:
        isz = 2 if dtype == "bfloat16" else 4
        total += bound_s(*depth_tap_conv_fwd(*shape, isz), dtype)
        if backward:
            total += bound_s(*depth_tap_conv_dx(*shape, isz), dtype)
    return total


def model_flops(fn) -> int:
    """Floating-point operations that `fn()` runs, as torch's flop counter
    counts them (matmuls, convs and their gradients); run it on the meta
    device so that nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())
