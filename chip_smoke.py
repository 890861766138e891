#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (eval_driving_safety_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. print the card's name and power limit; build every CUDA kernel
     (one nvcc per source, all at once);
  2. hold each kernel against its plain PyTorch version on the card at the
     paper-scale (DSGNConfig.full()) shapes of the attack, in bf16 and
     fp32, and at the training step's shapes (DSGNConfig(), bf16), and
     time kernel, plain version and a library yardstick on two
     clocks: `ms` is one call timed with CUDA events, host dispatch
     included, and `device_ms` the card's own time for the call (calls
     queued behind a sleep kernel, utils/cuda_timing.py); hold the bf16
     depth-tap conv (forward
     and dx) at the edges of its tiles and on misaligned views; time the
     weight-gradient kernel alone (not on the attack path; phase 5 runs
     it in training); hold K1 and K2
     (forward and backward PSV warp) at the edges of their design: other
     channel counts and access widths, ragged and long rows, per-image
     and out-of-range disparities, the unfused warp, misaligned views and
     a non-contiguous gradient;
  3. run the tiny model in fp32 on the card and on the CPU with the same
     weights and inputs and compare the loss and the input gradients;
  4. run the attack CLI at --scale paper on two seeded KITTI-layout frames
     (3 iterations), check the output sweep, that the kernels were
     launched at the shapes phase 2 checked, K1 and K2 with 16-byte
     accesses only, without alignment or contiguity copies, and that
     --transfer full writes the same PNGs; time the
     steady-state attack iteration and
     profile one. The kernels' per-iteration times weight phase 2's
     per-shape times by the launches the wrappers recorded in this run.
     The attack path must never launch the weight-gradient kernel;
  5. train at DSGNConfig() in bf16: write seeded velodyne scans, make
     depth ground truth with the make_depth_gt CLI, run the training CLI
     for 2 epochs (a checkpoint each) and resume it for a third; check
     finite losses, FrozenBatchNorm statistics bit for bit at their init
     in every checkpoint, and that the step launched every kernel at the
     shapes phase 2 timed, the weight gradient once per depth-tap
     forward; run the attack CLI on the last checkpoint; time the
     steady-state training step and profile one (`train_step`).
The line before the last is the kernels' JSON record (the four kernels
of the attack per attack iteration, the weight gradient per training
step); the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# bf16 outputs are rounded to 8 significant bits: kernel and plain
# version may round an f32 result of another summation order to
# neighbouring values, one bf16 step = 2^-8 of the value
RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# f32 sums over the whole grid (dW, d inv, d off) add ~3e6 terms
RTOL_GRID = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
PEAK_BYTES = 3.35e12                          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
SOURCES = {
    "psv_warp_fwd": ("eval_driving_safety_tpu_torch/csrc/psv_warp.cu",
                     "eval_driving_safety_tpu/ops/pallas_psv.py:56"),
    "psv_warp_bwd": ("eval_driving_safety_tpu_torch/csrc/psv_warp.cu",
                     "eval_driving_safety_tpu/ops/pallas_psv.py:71"),
    "depth_tap_conv_fwd": (
        "eval_driving_safety_tpu_torch/csrc/depth_tap_conv.cu",
        "eval_driving_safety_tpu/ops/pallas_depthconv.py:78"),
    "depth_tap_conv_bwd": (
        "eval_driving_safety_tpu_torch/csrc/depth_tap_conv.cu",
        "eval_driving_safety_tpu/ops/pallas_depthconv.py:94"),
    # the dW / d inv / d off half of the same TPU kernel, on the training
    # path only
    "depth_tap_conv_wgrad": (
        "eval_driving_safety_tpu_torch/csrc/depth_tap_conv.cu",
        "eval_driving_safety_tpu/ops/pallas_depthconv.py:94"),
}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def time_ms(fn, reps=10):
    """Median over `reps` of one call, timed with CUDA events after two
    warm-up calls. The card idles while the host dispatches inside the
    call, so for a small kernel this is mostly host time."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


TIME_KEYS = ("ms", "device_ms", "plain_ms", "plain_device_ms",
             "library_ms", "library_device_ms")


def timed(kernel, plain, library):
    """Kernel, plain version and library call, each on both clocks."""
    from eval_driving_safety_tpu_torch.utils.cuda_timing import device_ms
    t = {}
    for pre, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        t[pre + "ms"] = time_ms(fn)
        t[pre + "device_ms"] = device_ms(fn)
    return t


def attack_launches_ok(launches):
    """The attack path (input gradients only) launches every kernel but
    the weight-gradient one, which it must never launch."""
    return launches["depth_tap_conv_wgrad"] == 0 and all(
        v > 0 for k, v in launches.items() if k != "depth_tap_conv_wgrad")


def max_err(got, want):
    return float((got.detach().float() - want.detach().float()).abs().max())


def compare(name, got, want, rtol):
    err = max_err(got, want)
    scale = max(float(want.detach().float().abs().max()), 1e-30)
    check(err <= rtol * scale and math.isfinite(err),
          f"{name}: max |kernel - plain| {err:.3g} > {rtol:.3g} x {scale:.3g}")
    return err


# --------------------------------------------------------------- phase 2

def depthconv_shapes(c):
    """The depth-conv launch shapes (B, D, N, C, F) of one forward of
    config `c` at batch 1: the shapes phase 2 checks and times. The slice
    in phase 4 must launch exactly these (the wrappers record them)."""
    d, h, w = c.num_depth_planes, c.height // 4, c.width // 4
    pc, gc = c.psv_channels, c.gv_channels
    half = lambda n: -(-n // 2)
    return [
        (1, d, h * w, pc, pc),                               # x0, u0, gv in
        (1, half(d), half(h) * half(w), 2 * pc, 2 * pc),
        (1, half(half(d)), half(half(h)) * half(half(w)), 2 * pc, 2 * pc),
        (1, c.num_voxels_z, c.num_voxels_y * c.num_voxels_x, gc, gc),
    ]


def psv_library(fl, fr, disps):
    """The fused PSV as one library call: `F.grid_sample` (bilinear, zero
    padding, align_corners=True) of fr at (x - disp_d, h), then the
    concatenation with fl tiled over D. It differs from the kernel only
    within one pixel of each row's ends, which the kernel's mask zeroes,
    and by its grid being held in fr's dtype (grid_sample wants one
    dtype). The grid is built once, outside the timed call."""
    import torch
    import torch.nn.functional as F
    b, h, w, c = fr.shape
    d = disps.shape[1]
    dev = fr.device
    gx = 2.0 * (torch.arange(w, device=dev) - disps[..., None]) / (w - 1) - 1
    gy = 2.0 * torch.arange(h, device=dev) / max(h - 1, 1) - 1
    grid = torch.stack(torch.broadcast_tensors(
        gx[:, :, None, :], gy[None, None, :, None]), dim=-1)
    grid = grid.reshape(b, d * h, w, 2).to(fr.dtype)

    def call(a, r):
        warped = F.grid_sample(r.permute(0, 3, 1, 2), grid, mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        warped = warped.view(b, c, d, h, w).permute(0, 2, 3, 4, 1)
        return torch.cat([a[:, None].expand(-1, d, -1, -1, -1), warped],
                         dim=-1)
    return call


def check_psv(c, dtype_name, dev, per):
    import torch
    from eval_driving_safety_tpu_torch.ops.cost_volume import (
        depth_planes, shift_along_width)
    from eval_driving_safety_tpu_torch.ops.psv_warp import (
        build_psv, plane_disparities)
    dt = getattr(torch, dtype_name)
    h, w, ch, d = c.height // 4, c.width // 4, c.feature_channels, \
        c.num_depth_planes
    g = torch.Generator(device=dev).manual_seed(0)
    fl, fr = (torch.randn(1, h, w, ch, device=dev, generator=g).to(dt)
              for _ in range(2))
    fu = torch.tensor([721.5377], device=dev).to(dt)
    bl = torch.tensor([0.54], device=dev).to(dt)
    planes = depth_planes(c.min_depth, c.max_depth, d, device=dev).to(dt)
    disps = plane_disparities(fu, bl, planes, 4).contiguous()

    def plain(a, b):
        return torch.cat([a[:, None].expand(-1, d, -1, -1, -1),
                          shift_along_width(b, disps)], dim=-1)

    with torch.no_grad():
        out = build_psv(fl, fr, fu, bl, planes, 4)
        ref = plain(fl, fr)
    e1 = compare(f"psv_warp_fwd {dtype_name}", out, ref, RTOL[dtype_name])
    gout = torch.randn(out.shape, device=dev, generator=g).to(dt)
    kl, kr = (t.clone().requires_grad_(True) for t in (fl, fr))
    pl_, pr_ = (t.clone().requires_grad_(True) for t in (fl, fr))
    ll, lr = (t.clone().requires_grad_(True) for t in (fl, fr))
    kout = build_psv(kl, kr, fu, bl, planes, 4)
    pout = plain(pl_, pr_)
    lib = psv_library(fl, fr, disps)
    lout = lib(ll, lr)
    kg = torch.autograd.grad(kout, (kl, kr), gout, retain_graph=True)
    pg = torch.autograd.grad(pout, (pl_, pr_), gout, retain_graph=True)
    e2 = max(compare(f"psv_warp_bwd {n} {dtype_name}", a, b,
                     RTOL[dtype_name])
             for n, a, b in zip(("dfl", "dfr"), kg, pg))
    isz = torch.finfo(dt).bits // 8
    n_out = out.numel()
    fwd_bytes = (2 * fl.numel() + n_out) * isz + disps.numel() * 4
    bwd_bytes = (n_out + 2 * fl.numel()) * isz + disps.numel() * 4
    fwd_ops = 3 * n_out // 2          # one lerp per warped element
    shape = (1, d, h, w, ch)
    with torch.no_grad():
        per[("psv_warp_fwd", shape, dtype_name)] = dict(
            err=e1, **timed(lambda: build_psv(fl, fr, fu, bl, planes, 4),
                            lambda: plain(fl, fr), lambda: lib(fl, fr)),
            bytes=fwd_bytes, ops=fwd_ops)
    per[("psv_warp_bwd", shape, dtype_name)] = dict(
        err=e2, **timed(
            lambda: torch.autograd.grad(kout, (kl, kr), gout,
                                        retain_graph=True),
            lambda: torch.autograd.grad(pout, (pl_, pr_), gout,
                                        retain_graph=True),
            lambda: torch.autograd.grad(lout, (ll, lr), gout,
                                        retain_graph=True)),
        bytes=bwd_bytes, ops=fwd_ops + n_out // 2)


def check_depthconv(cfg, dtype_name, dev, per, wgrad):
    import torch
    import torch.nn.functional as F
    from eval_driving_safety_tpu_torch.ops.depthconv import (
        depth_tap_conv, reference_depth_tap_conv,
        reference_depth_tap_conv_wgrad)
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(1)
    isz = torch.finfo(dt).bits // 8
    for b, d, n, c, f in depthconv_shapes(cfg):
        x = (torch.randn(b, d, n, 1, c, device=dev, generator=g) * 0.5).to(dt)
        w = (torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5).to(dt)
        inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(dt)
        off = (0.1 * torch.randn(f, device=dev, generator=g)).to(dt)
        dy = torch.randn(b, d, n, 1, f, device=dev, generator=g).to(dt)
        tag = f"{(b, d, n, c, f)} {dtype_name}"
        with torch.no_grad():
            y = depth_tap_conv(x, w, inv, off)
            y_ref = reference_depth_tap_conv(x, w, inv, off)
        e_f = compare(f"depth_tap_conv_fwd {tag}", y, y_ref, RTOL[dtype_name])

        # The backward is held against the plain version's VJP under the
        # ReLU mask of the kernel's own forward (dm = dy * 1[y > 0], as the
        # kernel computes it): where a pre-activation lies within rounding
        # of 0 the two forwards may disagree on its sign, which would move
        # one masked gradient element by O(|dy| |W|).
        dm = dy * (y > 0)
        # main-path backward: dx only (the attack's weights need no grad)
        xk = x.clone().requires_grad_(True)
        yk = depth_tap_conv(xk, w, inv, off)
        xp = x.clone().requires_grad_(True)
        yp = reference_depth_tap_conv(xp, w, inv, off, relu=False)
        (dxk,) = torch.autograd.grad(yk, xk, dy, retain_graph=True)
        (dxp,) = torch.autograd.grad(yp, xp, dm, retain_graph=True)
        e_dx = compare(f"depth_tap_conv_bwd dx {tag}", dxk, dxp,
                       RTOL[dtype_name])
        # full backward: dx, dW, d inv, d off
        ka = [t.clone().requires_grad_(True) for t in (x, w, inv, off)]
        pa = [t.clone().requires_grad_(True) for t in (x, w, inv, off)]
        yk_all = depth_tap_conv(*ka)
        yp_all = reference_depth_tap_conv(*pa, relu=False)
        kg = torch.autograd.grad(yk_all, ka, dy, retain_graph=True)
        pg = torch.autograd.grad(yp_all, pa, dm, retain_graph=True)
        # the dx kernel's error is e_dx; the weight-gradient kernel's
        # covers dW, d inv, d off
        e_w = 0.0
        for name, a, p_ in zip(("dx", "dW", "d inv", "d off"), kg, pg):
            rt = RTOL[dtype_name] if name == "dx" else RTOL_GRID[dtype_name]
            e = compare(f"depth_tap_conv_bwd {name} {tag}", a, p_, rt)
            e_w = e_w if name == "dx" else max(e_w, e)
        # the weight-gradient kernel alone (x needs no gradient), also
        # against its plain G-form version under the kernel's forward and,
        # in bf16, bit for bit from one call to the next
        kw = [t.clone().requires_grad_(True) for t in (w, inv, off)]
        pw = [t.clone().requires_grad_(True) for t in (w, inv, off)]
        yk_w = depth_tap_conv(x, *kw)
        yp_w = reference_depth_tap_conv(x, *pw)
        kgw = torch.autograd.grad(yk_w, kw, dy, retain_graph=True)
        ref_w = reference_depth_tap_conv_wgrad(
            x[:, :, :, 0], yk_w.detach()[:, :, :, 0], dy[:, :, :, 0], w, inv)
        for name, a, r in zip(("dW", "d inv", "d off"), kgw, ref_w):
            e_w = max(e_w, compare(f"depth_tap_conv_wgrad {name} vs G form "
                                   f"{tag}", a, r, RTOL_GRID[dtype_name]))
        if dtype_name == "bfloat16":
            again = torch.autograd.grad(yk_w, kw, dy, retain_graph=True)
            check(all(torch.equal(a, b) for a, b in zip(kgw, again)),
                  f"depth_tap_conv_wgrad {tag}: two calls differ")

        # library yardsticks: the conv alone, as cuDNN computes it
        xc = x.permute(0, 4, 1, 2, 3)                   # (B, C, D, N, 1)
        wc = w.permute(2, 1, 0)[..., None, None]        # (F, C, 3, 1, 1)
        dyc = dy.permute(0, 4, 1, 2, 3)
        with torch.no_grad():
            t_f = timed(lambda: depth_tap_conv(x, w, inv, off),
                        lambda: reference_depth_tap_conv(x, w, inv, off),
                        lambda: F.conv3d(xc, wc, padding=(1, 0, 0)))
        # the plain version's own backward (ReLU included) for its time
        yp_relu = reference_depth_tap_conv(xp, w, inv, off)
        t_b = timed(
            lambda: torch.autograd.grad(yk, xk, dy, retain_graph=True),
            lambda: torch.autograd.grad(yp_relu, xp, dy, retain_graph=True),
            lambda: torch.ops.aten.convolution_backward(
                dyc, xc, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, [True, False, False]))
        ms_full = time_ms(lambda: torch.autograd.grad(yk_all, ka, dy,
                                                      retain_graph=True))
        t_w = timed(
            lambda: torch.autograd.grad(yk_w, kw, dy, retain_graph=True),
            lambda: torch.autograd.grad(yp_w, pw, dy, retain_graph=True),
            lambda: torch.ops.aten.convolution_backward(
                dyc, xc, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, [False, True, False]))
        vol_in, vol_out = b * d * n * c, b * d * n * f
        small = (3 * c * f + 2 * f) * isz
        conv_ops = 2 * 3 * c * f * b * d * n
        shape = (b, d, n, c, f)
        per[("depth_tap_conv_fwd", shape, dtype_name)] = dict(
            err=e_f, **t_f,
            bytes=(vol_in + vol_out) * isz + small, ops=conv_ops)
        # dx reads y and dy, writes dx
        per[("depth_tap_conv_bwd", shape, dtype_name)] = dict(
            err=e_dx, **t_b, full_backward_ms=ms_full,
            bytes=(2 * vol_out + vol_in) * isz + small, ops=conv_ops)
        # dW, d inv, d off read x, y and dy and write f32 sums; d inv is
        # sum_k W G over the same sums G as dW, so the operations are one
        # conv's
        wgrad[("depth_tap_conv_wgrad", shape, dtype_name)] = dict(
            err=e_w, **t_w,
            bytes=(2 * vol_out + vol_in) * isz + small + (3 * c + 2) * f * 4,
            ops=conv_ops)
        del yk, yp, yp_relu, yk_all, yp_all, yk_w, yp_w


def check_depthconv_edges(dev):
    """The bf16 depth-tap conv, forward and dx, against the plain version
    at the edges of the tensor-core kernels' tiles: N ragged against the
    64-pixel tile, D of 1, 2, 3, D split into chunks across blocks with a
    last chunk of one plane (D = 13: chunks of 4 planes at widths up to
    32, of 3 at 64), C != F, widths of 8 (padded to the MMA's K of 16),
    ReLU on and off."""
    import torch
    from eval_driving_safety_tpu_torch.ops.depthconv import (
        depth_tap_conv, reference_depth_tap_conv)
    dt, rtol = torch.bfloat16, RTOL["bfloat16"]
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [(1, 1, 35, 32, 32), (2, 2, 35, 64, 32), (1, 3, 65, 32, 64),
             (1, 13, 35, 64, 32), (2, 13, 65, 8, 16), (1, 5, 65, 16, 8),
             (1, 4, 129, 64, 64), (1, 2, 1, 8, 8), (1, 9, 2561, 32, 32),
             (1, 7, 130, 16, 64)]
    worst = 0.0
    for b, d, n, c, f in cases:
        x = (torch.randn(b, d, n, 1, c, device=dev, generator=g) * 0.5).to(dt)
        w = (torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5).to(dt)
        inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(dt)
        off = (0.1 * torch.randn(f, device=dev, generator=g)).to(dt)
        dy = torch.randn(b, d, n, 1, f, device=dev, generator=g).to(dt)
        for relu in (True, False):
            tag = f"{(b, d, n, c, f)} relu={relu} bfloat16"
            xk = x.clone().requires_grad_(True)
            xp = x.clone().requires_grad_(True)
            y = depth_tap_conv(xk, w, inv, off, relu)
            y_ref = reference_depth_tap_conv(xp, w, inv, off, relu)
            compare(f"depth_tap_conv_fwd edge {tag}", y, y_ref, rtol)
            # dx under the kernel's own ReLU mask, as in check_depthconv
            dm = dy * (y.detach() > 0) if relu else dy
            yl = reference_depth_tap_conv(xp, w, inv, off, relu=False)
            (dxk,) = torch.autograd.grad(y, xk, dy)
            (dxp,) = torch.autograd.grad(yl, xp, dm)
            compare(f"depth_tap_conv_bwd dx edge {tag}", dxk, dxp, rtol)
            for a_, r_ in ((y, y_ref), (dxk, dxp)):
                worst = max(worst, max_err(a_, r_) / max(
                    float(r_.detach().float().abs().max()), 1e-30))
    copies = misaligned_views(dev)
    log(json.dumps({"depthconv_bf16_edges": {
        "cases": len(cases) * 2, "max_err_over_max_ref": worst,
        "rtol": rtol, "misaligned_view_copies": copies}}))


def check_depthconv_wgrad_edges(dev):
    """The bf16 weight gradient (split-K GEMM + ordered reduction) at the
    edges of its design, against its plain G-form version and the plain
    VJP under the kernel's own forward, and bit for bit from one call to
    the next: N ragged against the 64-pixel tile, D of 1, 2, 3, 13, B = 2,
    C != F, widths of 8, ReLU on and off, and slices that start or end
    inside a tile's run of planes (checked from the kernel's own
    workspace size)."""
    import torch
    from eval_driving_safety_tpu_torch.ops.depthconv import (
        depth_tap_conv, reference_depth_tap_conv,
        reference_depth_tap_conv_wgrad, wgrad_workspace_bytes)
    dt, rtol = torch.bfloat16, RTOL_GRID["bfloat16"]
    g = torch.Generator(device=dev).manual_seed(3)
    cases = [(2, 1, 65, 8, 16), (2, 2, 35, 16, 8), (2, 3, 1000, 8, 16),
             (2, 13, 130, 16, 8), (2, 13, 97, 64, 32), (2, 2, 2561, 32, 64),
             (2, 3, 4097, 64, 8)]
    worst, mid = 0.0, 0
    for b, d, n, c, f in cases:
        items = b * -(-n // 64) * d
        slices = wgrad_workspace_bytes(b, d, n, c, f) // (4 * f * (3 * c + 1))
        mid += any(s * items // slices % d for s in range(slices))
        x = (torch.randn(b, d, n, 1, c, device=dev, generator=g) * 0.5).to(dt)
        w = (torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5).to(dt)
        inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(dt)
        off = (0.1 * torch.randn(f, device=dev, generator=g)).to(dt)
        dy = torch.randn(b, d, n, 1, f, device=dev, generator=g).to(dt)
        for relu in (True, False):
            tag = f"{(b, d, n, c, f)} relu={relu} bfloat16"
            kw = [t.clone().requires_grad_(True) for t in (w, inv, off)]
            pw = [t.clone().requires_grad_(True) for t in (w, inv, off)]
            y = depth_tap_conv(x, *kw, relu)
            kg = torch.autograd.grad(y, kw, dy, retain_graph=True)
            again = torch.autograd.grad(y, kw, dy)
            check(all(torch.equal(a, b_) for a, b_ in zip(kg, again)),
                  f"depth_tap_conv_wgrad edge {tag}: two calls differ")
            ref = reference_depth_tap_conv_wgrad(
                x[:, :, :, 0], y.detach()[:, :, :, 0], dy[:, :, :, 0], w, inv,
                relu)
            dm = dy * (y.detach() > 0) if relu else dy
            yl = reference_depth_tap_conv(x, *pw, relu=False)
            vjp = torch.autograd.grad(yl, pw, dm)
            for name, a, r, v in zip(("dW", "d inv", "d off"), kg, ref, vjp):
                compare(f"depth_tap_conv_wgrad edge {name} {tag}", a, r, rtol)
                compare(f"depth_tap_conv_wgrad edge {name} vjp {tag}", a, v,
                        rtol)
                worst = max(worst, max_err(a, r) / max(
                    float(r.float().abs().max()), 1e-30))
    check(mid >= 3, f"only {mid} wgrad edge cases split a tile's planes")
    log(json.dumps({"depthconv_wgrad_bf16_edges": {
        "cases": len(cases) * 2, "cases_with_slices_mid_tile": mid,
        "max_err_over_max_ref": worst, "rtol": rtol,
        "bit_for_bit_repeats": True}}))


def edge_disparities(b, w, dev):
    """(b, 7) f32 disparities, other ones per image: none, whole, W - 1,
    past the row (W + 4.5), negative (-0.5) and fractional ones."""
    import torch
    rows = [[0.0, 3.0, w - 1.0, w + 4.5, -0.5, 2.25, 17.6],
            [1.5, 0.0, 5.0, w - 1.0, 40.25, -0.5, 0.75]]
    return torch.tensor(rows[:b], dtype=torch.float32, device=dev)


def psv_pair(b, h, w, c, dt, dev, g, make=lambda t: t):
    """Seeded fl, fr (B, H, W, C) through `make` (a view maker), leaves."""
    import torch
    return [make(torch.randn(b, h, w, c, device=dev, generator=g).to(dt))
            .detach().requires_grad_(True) for _ in range(2)]


def check_psv_edges(dev):
    """K1 and K2 against the plain version at the edges of their design,
    in bf16 and fp32: C of 4, 8, 12, 32 and 64 (8- and 16-byte accesses),
    W ragged against the backward's pixel tiles, B = 2 with other
    disparities per image, disparities 0, whole, W - 1, W + 4.5 and -0.5,
    a long row (W = 1000), and the unfused warp; then misaligned views,
    which take a narrower access and no copy, and a non-contiguous
    gradient, copied once and counted; both must give the aligned,
    contiguous result bit for bit."""
    import torch
    from eval_driving_safety_tpu_torch.ops.cost_volume import \
        shift_along_width
    from eval_driving_safety_tpu_torch.ops.psv_warp import (
        psv_from_disparities, psv_warp)
    cases = [(1, 3, 77, 4), (2, 5, 77, 8), (1, 4, 100, 12), (2, 3, 77, 32),
             (1, 2, 131, 64), (1, 1, 1000, 64)]
    g = torch.Generator(device=dev).manual_seed(4)
    worst, n = 0.0, 0
    for dtype_name in ("bfloat16", "float32"):
        dt, rtol = getattr(torch, dtype_name), RTOL[dtype_name]
        for b, h, w, c in cases:
            tag = f"{(b, h, w, c)} {dtype_name}"
            disps = edge_disparities(b, w, dev)
            d = disps.shape[1]
            kl, kr = psv_pair(b, h, w, c, dt, dev, g)
            pl_, pr_ = (t.detach().clone().requires_grad_(True)
                        for t in (kl, kr))
            gout = torch.randn(b, d, h, w, 2 * c, device=dev,
                               generator=g).to(dt)
            out = psv_from_disparities(kl, kr, disps)
            ref = torch.cat([pl_[:, None].expand(-1, d, -1, -1, -1),
                             shift_along_width(pr_, disps)], dim=-1)
            kg = torch.autograd.grad(out, (kl, kr), gout)
            pg = torch.autograd.grad(ref, (pl_, pr_), gout)
            # the unfused warp (psv_warp), forward and backward
            uk = psv_warp(kr, disps)
            up = shift_along_width(pr_, disps)
            gu = gout[..., c:].contiguous()
            (ugk,) = torch.autograd.grad(uk, kr, gu)
            (ugp,) = torch.autograd.grad(up, pr_, gu)
            for name, a_, r_ in (("psv_warp_fwd", out, ref),
                                 ("psv_warp_bwd dfl", kg[0], pg[0]),
                                 ("psv_warp_bwd dfr", kg[1], pg[1]),
                                 ("psv_warp_fwd unfused", uk, up),
                                 ("psv_warp_bwd unfused", ugk, ugp)):
                compare(f"{name} edge {tag}", a_, r_, rtol)
                worst = max(worst, max_err(a_, r_) / max(
                    float(r_.detach().float().abs().max()), 1e-30))
                n += 1
    views = psv_misaligned_views(dev)
    log(json.dumps({"psv_edges": {
        "checks": n, "max_err_over_max_ref": worst,
        "rtol": RTOL, "views": views}}))


def psv_misaligned_views(dev):
    """Fused PSV forward and backward on fl, fr and the gradient given as
    misaligned views, and on a non-contiguous gradient: the same bits as
    from aligned, contiguous inputs; the views take a narrower access and
    no copy, the non-contiguous gradient one counted copy."""
    import torch
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.ops.psv_warp import \
        psv_from_disparities
    rec = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        b, h, w, c = 1, 3, 77, 32
        disps = edge_disparities(b, w, dev)
        gseed = torch.Generator(device=dev)

        def run(make, make_g):
            gseed.manual_seed(5)
            kl, kr = psv_pair(b, h, w, c, dt, dev, gseed, make)
            gout = torch.randn(b, disps.shape[1], h, w, 2 * c, device=dev,
                               generator=gseed).to(dt)
            out = psv_from_disparities(kl, kr, disps)
            return (out, *torch.autograd.grad(out, (kl, kr), make_g(gout)))

        def noncontiguous(t):
            nc = torch.empty(t.shape[:-2] + t.shape[-1:] + t.shape[-2:-1],
                             dtype=t.dtype, device=t.device).transpose(-1, -2)
            return nc.copy_(t)

        keep = lambda t: t
        _cuda.reset_launches()
        want = run(keep, keep)
        check(set(_cuda.launch_widths) == {("psv_warp_fwd", 16),
                                           ("psv_warp_bwd", 16)},
              f"aligned views: widths {dict(_cuda.launch_widths)}")
        _cuda.reset_launches()
        got = run(offset_view, offset_view)
        widths = sorted(_cuda.launch_widths)
        check(all(wd < 16 for _, wd in widths) and not _cuda.align_copies,
              f"misaligned views: widths {widths}, copies "
              f"{dict(_cuda.align_copies)}")
        check(all(torch.equal(a, r) for a, r in zip(got, want)),
              f"misaligned views give other PSV results ({dtype_name})")
        _cuda.reset_launches()
        got = run(keep, noncontiguous)
        copies = dict(_cuda.align_copies)
        check(copies == {"psv_warp": 1},
              f"non-contiguous gradient: copies {copies}, not 1")
        check(all(torch.equal(a, r) for a, r in zip(got, want)),
              f"a non-contiguous gradient gives other results ({dtype_name})")
        rec[dtype_name] = {"misaligned_widths": [list(x) for x in widths],
                           "noncontiguous_copies": copies["psv_warp"]}
    _cuda.reset_launches()
    return rec


def offset_view(t, requires_grad=False):
    """A copy of `t` as a view that starts one element past an aligned
    allocation, so its data is not 16-byte aligned."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf.requires_grad_(requires_grad)[1:].view(t.shape)


def misaligned_views(dev):
    """The bf16 depth-tap conv on x, w and dy given as misaligned views:
    the wrapper copies each once, counted, and forward and dx equal those
    of aligned inputs bit for bit. Returns the copies counted."""
    import torch
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.ops.depthconv import depth_tap_conv
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(1, 5, 13, 5, 32, device=dev, generator=g) * 0.5).to(dt)
    w = (torch.randn(3, 32, 32, device=dev, generator=g) / 32 ** 0.5).to(dt)
    inv = (1 + 0.2 * torch.randn(32, device=dev, generator=g)).to(dt)
    off = (0.1 * torch.randn(32, device=dev, generator=g)).to(dt)
    dy = torch.randn(1, 5, 13, 5, 32, device=dev, generator=g).to(dt)
    xa = x.clone().requires_grad_(True)
    ya = depth_tap_conv(xa, w, inv, off)
    (dxa,) = torch.autograd.grad(ya, xa, dy)
    xm, wm, dym = offset_view(x, True), offset_view(w), offset_view(dy)
    check(all(t.data_ptr() % 16 for t in (xm, wm, dym)),
          "offset views are aligned")
    before = _cuda.align_copies["depth_tap_conv"]
    ym = depth_tap_conv(xm, wm, inv, off)
    (dxm,) = torch.autograd.grad(ym, xm, dym)
    copies = _cuda.align_copies["depth_tap_conv"] - before
    check(copies == 3, f"misaligned x, w, dy: {copies} copies, not 3")
    check(torch.equal(ym, ya) and torch.equal(dxm, dxa),
          "misaligned views give other results than aligned inputs")
    return copies


def per_iteration(per, counts, dtype_name):
    """Each kernel's record summed over one attack iteration: every
    per-shape time, byte and operation count of phase 2 times the
    launches per iteration that the slice recorded at that shape."""
    rec = {}
    for (name, shape, dt), v in per.items():
        if dt != dtype_name:
            continue
        n = counts[(name, shape)]
        r = rec.setdefault(name, dict(err=0.0, bytes=0, ops=0,
                                      launches_per_iter=0))
        r["err"] = max(r["err"], v["err"])
        for key in (*TIME_KEYS, "full_backward_ms", "bytes", "ops"):
            if key in v:
                r[key] = r.get(key, 0) + n * v[key]
        r["launches_per_iter"] += n
    return rec


def detail_rows(timed, counts):
    """One row per timed (kernel, shape, dtype): errors, times, bound and
    the launches per iteration or step at that shape."""
    rows = []
    for (k, s, dt), v in timed.items():
        row = dict(kernel=k, shape=list(s), dtype=dt,
                   launches_per_iter=counts.get((k, s), 0),
                   bound_ms=bound(v, dt)[0])
        row.update((m, v[m]) for m in ("err", *TIME_KEYS,
                                       "full_backward_ms") if m in v)
        rows.append(row)
    return rows


def bound(r, dtype_name):
    t_bytes = r["bytes"] / PEAK_BYTES * 1e3
    t_ops = r["ops"] / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# --------------------------------------------------------------- phase 3

def tiny_card_vs_cpu(dev):
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.config import DSGNConfig, replace
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    from eval_driving_safety_tpu_torch.ops import _cuda
    cfg = replace(DSGNConfig.tiny(), dtype="float32")
    rng = np.random.RandomState(0)
    il = rng.randint(0, 256, (1, 96, 320, 3)).astype(np.float32)
    ir = np.clip(np.roll(il, -6, axis=2) + rng.randint(-8, 9, il.shape),
                 0, 255).astype(np.float32)
    depth = rng.uniform(1.0, 70.0, (1, 96, 320)).astype(np.float32)
    boxes = np.zeros((1, 4, 8), np.float32)
    boxes[0, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    cpu_model = DSGN(cfg).init_weights(seed=3).requires_grad_(False)
    card_model = DSGN(cfg).requires_grad_(False)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.to(dev)
    mean = torch.tensor([0.485, 0.456, 0.406]) * 255.0
    std = torch.tensor([0.229, 0.224, 0.225]) * 255.0

    def run(model, device):
        t = lambda a: torch.as_tensor(a).to(device)
        xl, xr = (t(a).requires_grad_(True) for a in (il, ir))
        m, s = mean.to(device), std.to(device)
        calib = [t(np.full((1,), v, np.float32))
                 for v in (180.0, 0.54, 160.0, 48.0)]
        out = model((xl - m) / s, (xr - m) / s, *calib)
        loss, _ = dsgn_total_loss(out, t(depth), t(boxes),
                                  t(np.array([1])), cfg)
        gl, gr = torch.autograd.grad(loss, (xl, xr))
        return float(loss.detach()), gl.cpu(), gr.cpu()

    before = dict(_cuda.launches)
    lc, glc, grc = run(cpu_model, "cpu")
    lk, glk, grk = run(card_model, dev)
    moved = {k: _cuda.launches[k] - before[k] for k in before}
    # rtol 1e-4 on the loss, 1e-3 x max on the gradients: the same fp32
    # arithmetic summed in other orders through ~40 layers (TF32 off)
    check(abs(lk - lc) <= 1e-4 * abs(lc), f"tiny loss card {lk} cpu {lc}")
    ge = max(max_err(glk, glc) / float(glc.abs().max()),
             max_err(grk, grc) / float(grc.abs().max()))
    check(ge <= 1e-3, f"tiny input gradient card vs cpu: rel err {ge:.3g}")
    check(attack_launches_ok(moved),
          f"tiny card run: launches {moved}, expected every kernel of the "
          "attack path and no weight gradient")
    log(json.dumps({"tiny_card_vs_cpu": {"loss_card": lk, "loss_cpu": lc,
                                         "grad_max_rel_err": ge,
                                         "launches": moved}}))


# --------------------------------------------------------------- phase 4

CALIB = ("P2: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 "
         "0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 "
         "0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03\n"
         "P3: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 "
         "0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 "
         "0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03\n"
         "R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 "
         "9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 "
         "9.999631e-01\n"
         "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 "
         "-4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 "
         "-7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 "
         "-2.717806e-01\n")
LABELS = ("Car 0.00 0 -1.58 587.0 173.0 614.0 200.0 1.65 1.67 3.64 "
          "-0.65 1.71 46.70 -1.59\n"
          "Car 0.00 0 1.85 280.0 185.0 420.0 240.0 1.50 1.60 3.90 "
          "-6.50 1.70 15.00 1.45\n")


def write_frames(root, ids):
    """Seeded KITTI-layout stereo frames (375 x 1242 PNGs): smooth random
    scenes, the right view shifted by a disparity that falls with height."""
    import numpy as np
    from eval_driving_safety_tpu_torch.data.kitti import write_png
    for sub in ("image_2", "image_3", "calib", "label_2"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(0)
    h, w = 375, 1242
    for fid in ids:
        coarse = rng.randint(0, 256, (h // 15 + 2, w // 18 + 2, 3))
        left = np.repeat(np.repeat(coarse, 15, 0), 18, 1)[:h, :w]
        left = np.clip(left + rng.randint(-12, 13, left.shape), 0, 255)
        right = np.empty_like(left)
        for y in range(h):
            right[y] = np.roll(left[y], -int(8 + 40 * y / h), axis=0)
        write_png(os.path.join(root, "image_2", fid + ".png"),
                  left.astype(np.uint8))
        write_png(os.path.join(root, "image_3", fid + ".png"),
                  right.astype(np.uint8))
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write(LABELS)


def run_cli(args, main=None):
    """Run a CLI's `main` (default: the attack's) on `args`; returns its
    wall time, the losses it printed and its output."""
    if main is None:
        from eval_driving_safety_tpu_torch.cli.pgd_attack import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(args)
    dt = time.perf_counter() - t0
    out = buf.getvalue()
    losses = [json.loads(m) for m in re.findall(r"losses (\[[^\]]*\])", out)]
    return dt, losses, out


def the_slice(tmp, card, dev, scale="paper"):
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.data.kitti import load_image_u8
    from eval_driving_safety_tpu_torch.ops import _cuda
    ids, iters = ["000001", "000002"], 3
    data = os.path.join(tmp, "kitti")
    write_frames(data, ids)
    common = ["--data_path", data, "--detector", "dsgn", "--scale", scale,
              "--iter", str(iters), "--batch", "1", "--device", str(dev)]
    _cuda.reset_launches()
    t_signs, losses, _ = run_cli(common + [
        "--out_prefix", os.path.join(tmp, "signs", "dsgn_pgd")])
    launches = dict(_cuda.launches)
    shapes = dict(_cuda.launch_shapes)
    widths = dict(_cuda.launch_widths)
    check(attack_launches_ok(launches),
          f"the paper-scale sweep: launches {launches}, expected every "
          "kernel of the attack path and no weight gradient")
    # K1 and K2 ran their 16-byte variant only
    check({k for k, _ in widths} == {"psv_warp_fwd", "psv_warp_bwd"}
          and {wd for _, wd in widths} == {16},
          f"the sweep's PSV access widths {widths}, not 16 bytes only")
    # no input of the sweep needed a copy to meet a kernel's alignment or
    # layout: every byte the kernels move is in their timed cost
    copies = dict(_cuda.align_copies)
    check(not copies, f"the sweep made alignment copies: {copies}")
    check(len(losses) == len(ids) and all(
        len(l) == iters and all(math.isfinite(v) for v in l)
        for l in losses), f"losses not finite: {losses}")
    t_full, losses_full, _ = run_cli(common + [
        "--out_prefix", os.path.join(tmp, "full", "dsgn_pgd"),
        "--transfer", "full"])
    eps = 76.5
    for fid in ids:
        clean = load_image_u8(os.path.join(data, "image_2", fid + ".png"))
        for k in range(iters + 1):
            for sub in ("image_2", "image_3"):
                rel = os.path.join(f"dsgn_pgd_iters_{k}", sub, fid + ".png")
                a = os.path.join(tmp, "signs", rel)
                b = os.path.join(tmp, "full", rel)
                check(os.path.exists(a), f"missing {rel}")
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    check(fa.read() == fb.read(),
                          f"{rel}: --transfer signs and full differ")
            adv = load_image_u8(os.path.join(tmp, "signs", f"dsgn_pgd_iters_"
                                             f"{k}", "image_2", fid + ".png"))
            # the tiny scale crops frames to its 96 x 320 input
            check(scale != "paper" or adv.shape == clean.shape,
                  f"{fid}: saved {adv.shape} != frame {clean.shape}")
            ref = clean[:adv.shape[0], :adv.shape[1]]
            diff = np.abs(adv.astype(int) - ref.astype(int)).max()
            check(diff <= math.ceil(eps),
                  f"{fid} iter {k}: |adv - clean| = {diff} > eps")
            check((k == 0) == (diff == 0), f"{fid} iter {k}: diff {diff}")
    n_pairs = len(ids)
    log(json.dumps({"slice": {
        "scale": scale, "frames": n_pairs, "iters": iters,
        "signs_run_s": t_signs, "full_run_s": t_full,
        "pairs_per_s_signs_run": n_pairs / t_signs,
        "attack_iters_per_s_signs_run": n_pairs * iters / t_signs,
        "losses": losses, "launches": launches,
        "vector_bytes": {f"{k} {wd}": v for (k, wd), v in widths.items()},
        "align_copies": sum(copies.values()), "card": card}}))
    return launches, shapes, widths, n_pairs * iters


def profile_kernels(fn):
    """Profile one call of `fn`: (device kernel rows (us, name, count),
    largest first; their total us; the port's kernels' us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device kernels only: operator rows, and user annotations on the
    # device such as the optimizer's step range, would count their
    # kernels again
    rows = sorted(((getattr(ev, "self_device_time_total", 0), ev.key,
                    ev.count) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and not ev.is_user_annotation), reverse=True)
    total_us = sum(r[0] for r in rows)
    port_us = sum(r[0] for r in rows
                  if re.search(r"\b(psv|dtc)_\w+_kernel", r[1]))
    return rows, total_us, port_us


def steady_state(cfg, dev, card):
    """Steady-state attack iteration (loss + input gradient + update) of
    config `cfg` on one seeded frame pair, and a profile of one."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack import objectives as O
    from eval_driving_safety_tpu_torch.attack.pgd import pgd_attack
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    model = DSGN(cfg).init_weights(0).to(dev).requires_grad_(False)
    rng = np.random.RandomState(1)
    t = lambda a: torch.as_tensor(a).to(dev)
    hw = (cfg.input.height, cfg.input.width)
    il = t(rng.randint(0, 256, (1, *hw, 3)).astype(np.float32))
    ir = t(np.roll(il.cpu().numpy(), -20, axis=2))
    mean = t(np.asarray(cfg.input.mean, np.float32) * 255)
    std = t(np.asarray(cfg.input.std, np.float32) * 255)
    calib = [t(np.full((1,), v, np.float32))
             for v in (721.5377, 0.54, 609.5593, 172.854)]
    depth = torch.zeros(1, *hw, device=dev)
    boxes = t(np.array([[[-0.65, 1.71, 46.7, 1.65, 1.67, 3.64, -1.59, 1.0]]],
                       np.float32))

    def loss_fn(a, b):
        out = model((a - mean) / std, (b - mean) / std, *calib)
        return O.total_loss(out, depth, boxes, t(np.array([1])), cfg)

    def attack(n):
        return pgd_attack(loss_fn, il, ir, num_iters=n, alpha=1.0, eps=76.5,
                          clip_min=0.0, clip_max=255.0, collect="signs1")

    attack(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    res = attack(n)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / n
    check(bool(torch.isfinite(res.losses).all()), "steady-state losses")
    peak = torch.cuda.max_memory_allocated()
    rows, total_us, port_us = profile_kernels(lambda: attack(1))
    log(json.dumps({"steady_state": {
        "depth_planes": cfg.num_depth_planes,
        "attack_iter_ms": per_iter * 1e3,
        "attack_iters_per_s": 1.0 / per_iter,
        "peak_device_mem_gib": peak / 2 ** 30,
        "profiled_kernel_ms": total_us / 1e3,
        "device_busy_share": (total_us / 1e3) / (per_iter * 1e3),
        "port_kernel_ms": port_us / 1e3,
        "top_kernels_ms": [[k[:70], c, us / 1e3] for us, k, c in rows[:16]],
        "card": card}}))


# --------------------------------------------------------------- phase 5

def write_velodyne(root, ids, n=120000):
    """Seeded velodyne scans of a KITTI scan's size (x forward, y left, z
    up, reflectance), beside the frames of `write_frames`."""
    import numpy as np
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    rng = np.random.RandomState(5)
    for fid in ids:
        pts = np.stack([rng.uniform(2.0, 80.0, n), rng.uniform(-30.0, 30.0, n),
                        rng.uniform(-2.5, 2.0, n), rng.uniform(0.0, 1.0, n)],
                       axis=1).astype(np.float32)
        pts.tofile(os.path.join(root, "velodyne", fid + ".bin"))


def train_losses(out):
    return {int(e): float(v) for e, v in
            re.findall(r"epoch (\d+): loss (\S+)", out)}


def training(tmp, dev, timed_shapes):
    """The training CLI at DSGNConfig() in bf16 on two seeded frames with
    depth ground truth from make_depth_gt: 2 epochs with a checkpoint
    each, a resumed third, then the attack CLI on the last checkpoint.
    Returns the kernel launches of the first run and its launches per
    step at each (kernel, shape)."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli import make_depth_gt
    from eval_driving_safety_tpu_torch.cli.train_detector import \
        main as train_main
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        restore_checkpoint
    cfg = DSGNConfig()
    ids = ["000001", "000002"]
    data, depth = os.path.join(tmp, "kitti"), os.path.join(tmp, "depth")
    ck = os.path.join(tmp, "ckpts")
    write_frames(data, ids)
    write_velodyne(data, ids)
    make_depth_gt.main(["--data_path", data, "--out_dir", depth])
    returns = [int((np.load(os.path.join(depth, f + ".npy")) > 0).sum())
               for f in ids]
    check(all(r > 1000 for r in returns), f"depth gt returns {returns}")
    common = ["--data_path", data, "--detector", "dsgn", "--batch", "1",
              "--warmup_steps", "2", "--ckpt_every", "1", "--ckpt_dir", ck,
              "--depth_dir", depth, "--device", str(dev)]
    _cuda.reset_launches()
    t_train, _, out = run_cli(common + ["--epochs", "2"], train_main)
    launches = dict(_cuda.launches)
    shapes = dict(_cuda.launch_shapes)
    steps = 2 * len(ids)
    losses = train_losses(out)
    check(sorted(losses) == [1, 2] and all(
        math.isfinite(v) for v in losses.values()),
        f"training losses {losses}")
    _cuda.reset_launches()
    t_resume, _, out = run_cli(common + ["--epochs", "1", "--resume"],
                               train_main)
    resumed = train_losses(out)
    check(f"resumed from {os.path.join(ck, 'epoch2')} (epoch 2)" in out
          and sorted(resumed) == [3] and math.isfinite(resumed[3]),
          f"the resumed run: losses {resumed}")
    check({k: 2 * v for k, v in _cuda.launches.items()} == launches,
          f"resumed launches {dict(_cuda.launches)} per step != {launches}")

    # FrozenBatchNorm statistics bit for bit at their init in every
    # checkpoint; the weights moved
    init = DSGN(cfg).init_weights(0).state_dict()
    stats = [k for k in init if k.rsplit(".", 1)[-1] in ("mean", "var")]
    cks = {e: restore_checkpoint(os.path.join(ck, f"epoch{e}"))
           for e in (1, 2, 3)}
    for e, c in cks.items():
        check(c["epoch"] == e and c["opt_state"]["count"] == 2 * e,
              f"epoch{e}: epoch {c['epoch']}, count "
              f"{c['opt_state']['count']}")
        moved = [k for k in stats if not torch.equal(c["params"][k], init[k])]
        check(not moved, f"epoch{e}: frozen statistics moved: {moved[:4]}")
    w = "StereoFeatureNet_0.ConvBnRelu_0.Conv_0.weight"
    check(not torch.equal(cks[3]["params"][w], cks[1]["params"][w]),
          "the weights did not move between epochs 1 and 3")

    # the wrappers' record: every kernel at the shapes phase 5 timed, in
    # bf16, the weight gradient once per forward launch at each shape
    counts = {}
    for (k, sh, dt), n in shapes.items():
        check(dt == cfg.dtype and n % steps == 0,
              f"training launched {k} {sh} {dt} {n} times in {steps} steps")
        counts[(k, sh)] = n // steps
    check(set(counts) == set(timed_shapes),
          f"training launch shapes {sorted(counts)} != timed shapes "
          f"{sorted(timed_shapes)}")
    for sh in depthconv_shapes(cfg):
        n = [counts.get((k, sh), 0) for k in ("depth_tap_conv_fwd",
                                                "depth_tap_conv_bwd",
                                                "depth_tap_conv_wgrad")]
        check(n[0] > 0 and n.count(n[0]) == 3,
              f"{sh}: fwd / dx / wgrad launches per step {n}")
    check(launches["depth_tap_conv_wgrad"] == 8 * steps
          and launches["psv_warp_fwd"] == launches["psv_warp_bwd"] == steps,
          f"training launches {launches} in {steps} steps")

    # the attack CLI on the trained checkpoint: no weight gradient
    _cuda.reset_launches()
    t_attack, attack_losses, out = run_cli([
        "--data_path", data, "--detector", "dsgn", "--scale", "default",
        "--iter", "2", "--batch", "1", "--device", str(dev),
        "--ckpt", os.path.join(ck, "epoch3"),
        "--out_prefix", os.path.join(tmp, "attack", "dsgn_pgd")])
    check(f"loaded DSGN weights from {os.path.join(ck, 'epoch3')}" in out
          and len(attack_losses) == len(ids) and all(
              math.isfinite(v) for l in attack_losses for v in l)
          and attack_launches_ok(dict(_cuda.launches)),
          f"attack on the trained checkpoint: losses {attack_losses}, "
          f"launches {dict(_cuda.launches)}")
    log(json.dumps({"training": {
        "config": "DSGNConfig()", "dtype": cfg.dtype, "frames": len(ids),
        "depth_gt_returns": returns, "train_run_s": t_train,
        "steps": steps, "losses": losses, "resume_run_s": t_resume,
        "resumed_losses": resumed, "launches": launches,
        "attack_on_checkpoint_s": t_attack,
        "attack_on_checkpoint_losses": attack_losses}}))
    return launches, counts


def train_grads_bit_for_bit(cfg, dev, batch):
    """Every parameter gradient of two identical training steps (the
    weights of `init_weights(0)`, one batch) compared by torch.equal, with
    library kernels in deterministic mode as the training CLI sets it."""
    import torch
    from eval_driving_safety_tpu_torch.cli.common import \
        use_deterministic_kernels
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    from eval_driving_safety_tpu_torch.ops import _cuda
    use_deterministic_kernels(dev)
    mean = torch.tensor(cfg.input.mean, device=dev)
    std = torch.tensor(cfg.input.std, device=dev)
    il, ir, calib, depth, boxes, nb = batch

    def grads():
        model = DSGN(cfg).init_weights(0).to(dev)
        out = model((u8_to_01(il) - mean) / std, (u8_to_01(ir) - mean) / std,
                    *calib)
        dsgn_total_loss(out, depth, boxes, nb, cfg)[0].backward()
        return {k: p.grad for k, p in model.named_parameters()
                if p.grad is not None}

    _cuda.reset_launches()
    a = grads()
    check(_cuda.launches["depth_tap_conv_wgrad"] == 8,
          f"a training step launched the weight gradient "
          f"{_cuda.launches['depth_tap_conv_wgrad']} times, not 8")
    b = grads()
    differ = sorted(k for k in a if not torch.equal(a[k], b.get(k)))
    check(set(a) == set(b) and not differ,
          f"two identical training steps: gradients differ in {differ[:6]}")
    log(json.dumps({"train_grads_bit_for_bit": {
        "parameters": len(a), "equal": True}}))


def train_steady_state(cfg, dev, card):
    """Steady-state training step (loss, every gradient, clip, AdamW) of
    config `cfg` on one seeded frame pair, as the training CLI runs it,
    and a profile of one."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli.train_detector import (
        make_detector_optimizer, make_train_step, warmup_cosine_decay)
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    model = DSGN(cfg).init_weights(0).to(dev)
    opt = make_detector_optimizer(model.named_parameters(),
                                  warmup_cosine_decay(1e-3, 2, 1000))
    step = make_train_step(model, opt, cfg, dev)
    rng = np.random.RandomState(2)
    t = lambda a: torch.as_tensor(a).to(dev)
    hw = (cfg.input.height, cfg.input.width)
    il = rng.randint(0, 256, (1, *hw, 3)).astype(np.uint8)
    ir = np.roll(il, -20, axis=2)
    depth = np.where(rng.rand(1, *hw) < 0.05,
                     rng.uniform(2.0, 60.0, (1, *hw)), 0.0)
    args = (t(il), t(ir), [t(np.full((1,), v, np.float32))
                           for v in (721.5377, 0.54, 609.5593, 172.854)],
            t(depth.astype(np.float32)),
            t(np.array([[[-0.65, 1.71, 46.7, 1.65, 1.67, 3.64, -1.59, 1.0]]],
                        np.float32)), t(np.array([1])))

    def steps(n):
        return [step(*args) for _ in range(n)]

    train_grads_bit_for_bit(cfg, dev, args)
    steps(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    losses = steps(n)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    check(all(bool(torch.isfinite(l)) for l in losses), "training losses")
    peak = torch.cuda.max_memory_allocated()
    rows, total_us, port_us = profile_kernels(lambda: steps(1))
    # the bf16 split-K GEMM and its reduction (and fp32's kernel)
    wgrad_us = sum(us for us, k, _ in rows if "dtc_wgrad_" in k)
    rec = {
        "depth_planes": cfg.num_depth_planes,
        "train_step_ms": per_step * 1e3, "train_steps_per_s": 1.0 / per_step,
        "peak_device_mem_gib": peak / 2 ** 30,
        "profiled_kernel_ms": total_us / 1e3,
        "device_busy_share": (total_us / 1e3) / (per_step * 1e3),
        "port_kernel_ms": port_us / 1e3,
        "wgrad_kernel_ms": wgrad_us / 1e3,
        "wgrad_share_of_kernel_time": wgrad_us / max(total_us, 1e-9),
        "wgrad_share_of_step": (wgrad_us / 1e3) / (per_step * 1e3),
        "top_kernels_ms": [[k[:70], c, us / 1e3] for us, k, c in rows[:16]],
        "card": card}
    log(json.dumps({"train_step": rec}))
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.ops import _cuda
    full = DSGNConfig.full()

    # 1. the card; build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _cuda.build_all()
    log(json.dumps({"build_s": time.perf_counter() - t0,
                    "nvcc": _cuda.nvcc_path()}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernels vs plain versions at the paper-scale shapes
    per, wgrad = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        check_psv(full, dtype_name, dev, per)
        check_depthconv(full, dtype_name, dev, per, wgrad)
        torch.cuda.empty_cache()
    # ... and at the training step's shapes (DSGNConfig(), bf16), before
    # any CLI turns on deterministic mode, under which the library
    # yardstick of K2 (grid_sample's backward) refuses to run
    cfg_t = DSGNConfig()
    timed_t, wgrad_t = {}, {}
    check_psv(cfg_t, cfg_t.dtype, dev, timed_t)
    check_depthconv(cfg_t, cfg_t.dtype, dev, timed_t, wgrad_t)
    timed_t.update(wgrad_t)
    torch.cuda.empty_cache()
    check_depthconv_edges(dev)
    check_depthconv_wgrad_edges(dev)
    check_psv_edges(dev)

    # 3. tiny model: card vs CPU
    tiny_card_vs_cpu(dev)
    torch.cuda.empty_cache()

    # 4. the slice at paper scale, then steady state
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, shapes, widths, n_iters = the_slice(tmp, card, dev)
    torch.cuda.empty_cache()
    steady_state(full, dev, card)

    # the slice launched each kernel at exactly the shapes phase 2 timed
    # (all in the model's dtype), the same number of times per iteration
    ran = {(k, s) for k, s, _ in shapes}
    phase2 = {(k, s) for k, s, dt in per if dt == full.dtype}
    check(ran == phase2 and {dt for _, _, dt in shapes} == {full.dtype},
          f"slice launch shapes {sorted(shapes)} != phase-2 shapes "
          f"{sorted(phase2)}")
    check(all(n % n_iters == 0 for n in shapes.values()),
          f"slice launches {shapes} not a multiple of {n_iters} iterations")
    counts = {(k, s): n // n_iters for (k, s, _), n in shapes.items()}
    # were the weights to need a gradient, the weight-gradient kernel would
    # run once per dx launch
    wcounts = {("depth_tap_conv_wgrad", s): n for (k, s), n in counts.items()
               if k == "depth_tap_conv_bwd"}
    log(json.dumps({"kernel_detail": detail_rows({**per, **wgrad}, counts)}))
    log(json.dumps({"kernel_wgrad_paper_shapes": {
        dt: dict(max_abs_err=r["err"], **{m: r[m] for m in TIME_KEYS},
                 bound_ms=bound(r, dt)[0], bound_by=bound(r, dt)[1],
                 launches_if_weights_had_grad=r["launches_per_iter"])
        for dt in ("bfloat16", "float32")
        for r in per_iteration(wgrad, wcounts, dt).values()}}))
    log(json.dumps({"kernel_fp32": {
        k: dict(max_abs_err=v["err"], **{m: v[m] for m in TIME_KEYS},
                bound_ms=bound(v, "float32")[0])
        for k, v in per_iteration(per, counts, "float32").items()}}))

    # 5. training at DSGNConfig() in bf16: the training CLI (checkpoints,
    # resume, the attack on its checkpoint) at the shapes phase 2 timed,
    # then steady state
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t_launches, t_counts = training(
            tmp, dev, {(k, s) for k, s, _ in timed_t})
    torch.cuda.empty_cache()
    train_steady_state(cfg_t, dev, card)
    log(json.dumps({"kernel_detail_train": detail_rows(timed_t, t_counts)}))
    rec_t = per_iteration(timed_t, t_counts, cfg_t.dtype)
    log(json.dumps({"kernels_train_step": {
        k: dict(launches_per_step=r["launches_per_iter"],
                max_abs_err=r["err"], **{m: r[m] for m in TIME_KEYS},
                bound_ms=bound(r, cfg_t.dtype)[0],
                bound_by=bound(r, cfg_t.dtype)[1])
        for k, r in rec_t.items()}}))

    # times, bytes and operations per attack iteration (the four kernels
    # of the attack path) or per training step (the weight gradient, which
    # only training launches): each shape's time times its launches per
    # iteration or step. `launches` counts the sweep's launches, or the
    # first training run's. `ms`, `plain_ms` and `library_ms` are
    # CUDA-event call times, the `*device_ms` the card's own; compare a
    # kernel with its yardsticks on one clock.
    rec = per_iteration(per, counts, full.dtype)
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        on_attack = name in rec
        r = rec[name] if on_attack else rec_t[name]
        dt = full.dtype if on_attack else cfg_t.dtype
        b_ms, b_by = bound(r, dt)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (launches if on_attack else t_launches)[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "bound_share": b_ms / r["ms"],
            "device_bound_share": b_ms / r["device_ms"],
            "per": "attack_iter" if on_attack else "train_step",
            "launches_per_attack_iter": r["launches_per_iter"]
            if on_attack else 0,
            "launches_per_train_step": rec_t[name]["launches_per_iter"],
            # K1, K2: the access widths (bytes) the sweep launched
            **({"vector_bytes": sorted(wd for k, wd in widths if k == name)}
               if name.startswith("psv") else {}),
            "dtype": dt})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
