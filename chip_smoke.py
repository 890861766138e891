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
  6. predict (cli/predict_and_save.py): the decode of the same
     paper-scale outputs on the card and on the CPU (score threshold 0:
     the same kept boxes); the CLI at --scale paper over phase 4's last
     attacked frames with AP, depth metrics and every export, launching
     K1 and K3 only at phase 2's forward shapes, twice with
     byte-identical txts; each --patch_mode with the card's composite
     equal to the CPU's; steady-state pairs/s, busy share, peak memory,
     host syncs per batch and the postprocessor's share
     (`predict_steady_state`); and, in phase 5, the CLI at --scale
     default on the last training checkpoint.
  7. the patch attack and the checkpoint-compat model: (a) the patch CLI
     at --scale paper over phase 4's frames, 2 epochs of 2 steps per
     frame, launching K1, K2, K3 and K4 dx at phase 2's shapes (1, 1, 8
     and 8 per step) and never the weight gradient, each epoch's change
     within eps x steps and none outside the circle, and a second run
     from the same epoch0 writing the same bytes; (b) one tiny fp32
     patch step on the card and on the CPU; (c) the steady-state patch
     step (`patch_steady_state`); (d) a random checkpoint at the
     upstream default arch in the published layout (DataParallel keys,
     BatchNorm statistics), read with no key unmapped by the attack,
     predict and patch CLIs at --scale paper, launching K1 once per
     forward, K2 once per backward and nothing else of the port; (e)
     the tiny compat model on the card and on the CPU; (f) the compat
     attack iteration's steady state and profile, its cuDNN 3D convs'
     time (`compat_steady_state`).
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


def steady_attack(model, cfg, dev, n=5):
    """Steady-state attack iteration (loss + input gradient + update) of
    `model` at config `cfg` on one seeded frame pair: its time and the
    peak memory, and `attack(k)`, which runs k iterations."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack import objectives as O
    from eval_driving_safety_tpu_torch.attack.pgd import pgd_attack
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

    def attack(k):
        return pgd_attack(loss_fn, il, ir, num_iters=k, alpha=1.0, eps=76.5,
                          clip_min=0.0, clip_max=255.0, collect="signs1")

    attack(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = attack(n)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / n
    check(bool(torch.isfinite(res.losses).all()), "steady-state losses")
    peak = torch.cuda.max_memory_allocated()
    return {"attack_iter_ms": per_iter * 1e3,
            "attack_iters_per_s": 1.0 / per_iter,
            "peak_device_mem_gib": peak / 2 ** 30}, attack


def steady_state(cfg, dev, card):
    """Steady-state attack iteration of the port's DSGN at config `cfg`,
    and a profile of one."""
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    model = DSGN(cfg).init_weights(0).to(dev).requires_grad_(False)
    ss, attack = steady_attack(model, cfg, dev)
    rows, total_us, port_us = profile_kernels(lambda: attack(1))
    log(json.dumps({"steady_state": {
        "depth_planes": cfg.num_depth_planes, **ss,
        "profiled_kernel_ms": total_us / 1e3,
        "device_busy_share": (total_us / 1e3) / ss["attack_iter_ms"],
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


# --------------------------------------------------------------- phase 6

# the kernels a forward launches: K1 once and K3 8 times per frame pair
PREDICT_PER_PAIR = {"psv_warp_fwd": 1, "depth_tap_conv_fwd": 8}


def predict_launches_ok(launches, pairs):
    """The predict path launches K1 and K3 only, at their per-pair
    counts: no backward kernel."""
    return all(launches[k] == PREDICT_PER_PAIR.get(k, 0) * pairs
               for k in launches)


def raised_bias_weights(cfg, path):
    """Seeded weights with the BEV class bias raised from -4.59 to +1.0:
    random weights score every cell under the default threshold, so the
    txts would be empty and NMS idle. Saved as a state dict for --ckpt."""
    import torch
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    model = DSGN(cfg).init_weights(0)
    with torch.no_grad():
        model.BEVHead_0.cls.bias.fill_(1.0)
    torch.save(model.state_dict(), path)
    return model


def write_depth_gt(root, ids):
    """Seeded sparse depth ground truth (a lidar-like 5% of the pixels)."""
    import numpy as np
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(6)
    for fid in ids:
        d = np.where(rng.rand(375, 1242) < 0.05,
                     rng.uniform(2.0, 60.0, (375, 1242)), 0.0)
        np.save(os.path.join(root, fid + ".npy"), d.astype(np.float32))


def decode_card_vs_cpu(tmp, cfg, dev):
    """(1) The decode of the same paper-scale outputs (the raised-bias
    weights on phase 4's last attacked pair) on the card and on the CPU
    with score_thresh 0, so all 256 candidates enter NMS: kept map
    indices, classes and masks identical, boxes and scores within 1e-5
    relative. Returns the card decode's time at the default threshold,
    fetch included."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli.predict_and_save import (
        Normalizer, upload)
    from eval_driving_safety_tpu_torch.config import replace
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_dsgn_batch_u8)
    adv = os.path.join(tmp, "signs", "dsgn_pgd_iters_3")
    ds = KittiStereoDataset(os.path.join(tmp, "kitti"),
                            image_2_dir=os.path.join(adv, "image_2"),
                            image_3_dir=os.path.join(adv, "image_3"))
    frames = prepare_dsgn_batch_u8([ds.get(0)], cfg.input)
    model = raised_bias_weights(cfg, os.path.join(tmp, "raised_bias.pt"))
    model = model.to(dev).requires_grad_(False).eval()
    from eval_driving_safety_tpu_torch.inference.fcos3d_post import (
        decode_bev_outputs, fetch_detections)
    from eval_driving_safety_tpu_torch.ops import nms
    cfg0 = replace(cfg, score_thresh=0.0)
    il, ir, calib = upload(frames, dev)
    with torch.inference_mode():
        norm = Normalizer(cfg, dev)
        out = model(norm(il), norm(ir), *calib)
        heads = {k: out[k] for k in ("bbox_cls", "bbox_reg",
                                     "bbox_centerness")}
        syncs = nms.host_syncs["nms_fixpoint"]
        card = fetch_detections(decode_bev_outputs(heads, cfg0))
        syncs = nms.host_syncs["nms_fixpoint"] - syncs
        cpu = fetch_detections(decode_bev_outputs(
            {k: v.cpu() for k, v in heads.items()}, cfg0))
        flat = torch.sigmoid(heads["bbox_cls"].double()) * torch.sigmoid(
            heads["bbox_centerness"].double())[..., None]
        top = torch.sort(flat.reshape(-1), descending=True).values[:256]
        ties = 256 - int(torch.unique(top).numel())

        def decode():
            return fetch_detections(decode_bev_outputs(heads, cfg))
        decode_ms = time_ms(decode, reps=20)
    check(np.array_equal(card.index, cpu.index)
          and np.array_equal(card.valid, cpu.valid)
          and np.array_equal(card.classes, cpu.classes),
          f"decode card vs cpu: kept {card.index[card.valid].tolist()} vs "
          f"{cpu.index[cpu.valid].tolist()}")
    check(int(card.valid.sum()) == cfg.max_detections,
          f"score_thresh 0: {int(card.valid.sum())} kept")
    for name, a, b in (("boxes", card.boxes3d, cpu.boxes3d),
                       ("scores", card.scores, cpu.scores)):
        err = float(np.abs(a - b).max())
        check(err <= 1e-5 * float(np.abs(b).max()),
              f"decode card vs cpu: {name} differ by {err:.3g}")
    rec = {"kept": int(card.valid.sum()), "tied_scores_in_top256": ties,
           "nms_fixpoint_syncs": syncs,
           "box_max_abs_err": float(np.abs(card.boxes3d
                                           - cpu.boxes3d).max()),
           "decode_ms": decode_ms}
    log(json.dumps({"predict_decode_card_vs_cpu": rec}))
    return decode_ms


def predict_layout_ok(res, ids, cfg, depth_dir=None, lidar_dir=None,
                      plot=False):
    import numpy as np
    for fid in ids:
        txt = os.path.join(res, "data", fid + ".txt")
        check(os.path.exists(txt), f"missing {txt}")
        with open(txt) as f:
            lines = f.read().splitlines()
        check(all(len(ln.split(" ")) == 16 for ln in lines),
              f"{txt}: not 16-field KITTI lines")
        if depth_dir:
            d = np.load(os.path.join(depth_dir, fid + ".npy"))
            hw = (cfg.input.height, cfg.input.width)
            check(d.shape == hw and np.isfinite(d).all(),
                  f"depth map {fid}: {d.shape}")
        if lidar_dir:
            n = os.path.getsize(os.path.join(lidar_dir, fid + ".bin"))
            check(n > 0 and n % 16 == 0, f"pseudo-lidar {fid}: {n} bytes")
        if plot:
            check(os.path.getsize(os.path.join(res, "refer", fid + ".png"))
                  > 0, f"no panel for {fid}")


def scale_cfg(scale):
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    return {"paper": DSGNConfig.full, "default": DSGNConfig,
            "tiny": DSGNConfig.tiny}[scale]()


def predict_cli(tmp, dev, fwd_shapes, scale="paper"):
    """(2) The predict CLI at --scale paper over phase 4's last attacked
    dirs, with AP, depth metrics and every export: K1 and K3 only, at
    phase 2's forward shapes; a second run writes byte-identical txts."""
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    ids = ["000001", "000002"]
    data = os.path.join(tmp, "kitti")
    adv = os.path.join(tmp, "signs", "dsgn_pgd_iters_3")
    write_depth_gt(os.path.join(tmp, "depth_gt"), ids)
    ckpt = os.path.join(tmp, "raised_bias.pt")
    cfg = scale_cfg(scale)
    raised_bias_weights(cfg, ckpt)
    common = ["--data_path", data, "--detector", "dsgn", "--scale", scale,
              "--device", str(dev), "--ckpt", ckpt,
              "--image_2_dir", os.path.join(adv, "image_2"),
              "--image_3_dir", os.path.join(adv, "image_3")]
    exports = ["--eval_ap", "--depth_dir", os.path.join(tmp, "depth_gt"),
               "--save_depth_dir", os.path.join(tmp, "pred_depth"),
               "--save_lidar_dir", os.path.join(tmp, "pred_lidar"), "--plot"]
    _cuda.reset_launches()
    t_a, _, out = run_cli(common + exports + [
        "--result_dir", os.path.join(tmp, "pred_a")], predict_main)
    launches = dict(_cuda.launches)
    shapes = dict(_cuda.launch_shapes)
    check(predict_launches_ok(launches, len(ids)),
          f"predict launches {launches}: K1 and K3 only, per pair "
          f"{PREDICT_PER_PAIR}")
    check({(k, s) for k, s, _ in shapes} == fwd_shapes
          and {dt for _, _, dt in shapes} == {"bfloat16"},
          f"predict launch shapes {sorted(shapes)} != phase-2 forward "
          f"shapes {sorted(fwd_shapes)}")
    check("AP (Car, moderate, IoU 0.70)" in out and "depth error" in out,
          f"predict CLI output: {out[-400:]}")
    predict_layout_ok(os.path.join(tmp, "pred_a"), ids, cfg,
                      os.path.join(tmp, "pred_depth"),
                      os.path.join(tmp, "pred_lidar"), plot=True)
    with open(os.path.join(tmp, "pred_a", "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    check(len(recs) == 2 and "ap_table" in recs[1]
          and math.isfinite(recs[0]["depth_mean_err"]),
          f"metrics.jsonl: {recs}")
    t_b, _, _ = run_cli(common + ["--result_dir", os.path.join(
        tmp, "pred_b")], predict_main)
    n_lines = 0
    for fid in ids:
        rel = os.path.join("data", fid + ".txt")
        with open(os.path.join(tmp, "pred_a", rel), "rb") as fa, \
                open(os.path.join(tmp, "pred_b", rel), "rb") as fb:
            a = fa.read()
            check(a == fb.read(), f"{rel}: two predict runs differ")
        n_lines += a.count(b"\n")
    check(n_lines > 0, "the predict runs exported no detection")
    rec = {"run_s": t_a, "rerun_s": t_b, "pairs": len(ids),
           "detections": n_lines, "launches": launches,
           "ap_moderate": {k: recs[1][k] for k in ("ap_bbox", "ap_bev",
                                                   "ap_3d")},
           "depth_mean_err_m": recs[0]["depth_mean_err"]}
    log(json.dumps({"predict_cli": rec}))
    return launches


def predict_patch_modes(tmp, dev, scale="paper"):
    """(4) --patch_npy in each of the four --patch_mode bands: the input
    the card composited (saved by --save_input_dir) equals the CPU
    composite of the same frame, and the patch composited on the card
    equals the CPU's bit for bit."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack.patch import (
        patch_dim_for, save_patch)
    from eval_driving_safety_tpu_torch.cli.predict_and_save import (
        composite, main as predict_main)
    from eval_driving_safety_tpu_torch.config import PLACEMENT_BANDS
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.data.kitti import (load_image_u8,
                                                          pad_to)
    from eval_driving_safety_tpu_torch.ops import _cuda
    data = os.path.join(tmp, "kitti")
    d = patch_dim_for(375, 0.2)
    rng = np.random.RandomState(8)
    pnpy = os.path.join(tmp, "patch.npy")
    save_patch(pnpy, torch.from_numpy(rng.rand(d, d, 3).astype(np.float32)))
    inp_cfg = scale_cfg(scale).input
    clean = [pad_to(load_image_u8(os.path.join(data, sub, "000001.png")),
                    inp_cfg.height, inp_cfg.width)[None]
             for sub in ("image_2", "image_3")]
    rec = {}
    for mode in PLACEMENT_BANDS:
        _cuda.reset_launches()
        inp = os.path.join(tmp, f"patch_in_{mode}")
        run_cli(["--data_path", data, "--detector", "dsgn", "--scale",
                 scale, "--device", str(dev), "--debug", "--debugnum",
                 "1", "--patch_npy", pnpy, "--patch_mode", mode,
                 "--save_input_dir", inp, "--result_dir",
                 os.path.join(tmp, f"patch_res_{mode}")], predict_main)
        check(predict_launches_ok(dict(_cuda.launches), 1),
              f"--patch_mode {mode}: launches {dict(_cuda.launches)}")
        with torch.inference_mode():
            card = composite(pnpy, mode, 0, *(u8_to_01(torch.from_numpy(
                c).to(dev)) for c in clean))
            cpu = composite(pnpy, mode, 0, *(u8_to_01(torch.from_numpy(c))
                                              for c in clean))
        for k, sub in enumerate(("image_2", "image_3")):
            check(torch.equal(card[k].cpu(), cpu[k]),
                  f"--patch_mode {mode} {sub}: card composite != cpu")
            saved = load_image_u8(os.path.join(inp, sub, "000001.png"))
            want = np.clip(cpu[k][0].numpy() * 255.0, 0, 255).astype(
                np.uint8)
            check(np.array_equal(saved, want),
                  f"--patch_mode {mode} {sub}: saved input != cpu composite")
        cols = np.nonzero((saved != clean[1][0]).any(-1).any(0))[0]
        rec[mode] = [int(cols.min()), int(cols.max())] if cols.size else []
    log(json.dumps({"predict_patch_modes": {"patch_dim": d,
                                            "right_view_columns": rec}}))


def predict_on_checkpoint(tmp, dev, fwd_shapes):
    """(3) The predict CLI at --scale default on phase 5's last
    checkpoint."""
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    ck = os.path.join(tmp, "ckpts", "epoch3")
    res = os.path.join(tmp, "pred_ckpt")
    _cuda.reset_launches()
    t, _, out = run_cli(["--data_path", os.path.join(tmp, "kitti"),
                         "--detector", "dsgn", "--scale", "default",
                         "--device", str(dev), "--ckpt", ck,
                         "--result_dir", res, "--eval_ap"], predict_main)
    launches = dict(_cuda.launches)
    shapes = {(k, s) for k, s, _ in _cuda.launch_shapes}
    check(f"loaded DSGN weights from {ck}" in out
          and predict_launches_ok(launches, 2) and shapes == fwd_shapes,
          f"predict on the trained checkpoint: launches {launches}, shapes "
          f"{sorted(shapes)}")
    predict_layout_ok(res, ["000001", "000002"], scale_cfg("default"))
    log(json.dumps({"predict_on_checkpoint": {"run_s": t,
                                              "launches": launches}}))


def predict_steady_state(tmp, dev, card, decode_ms, scale="paper"):
    """(5) Steady-state predict at --scale paper, batch 1, as the CLI runs
    it (PNG decodes prefetched on threads, upload, forward, decode, one
    fetch, txt writes): the CLI over 12 batches of two frames in turn,
    pairs/s from its per-batch times after the first two; the same loop
    in this process for the peak memory, the host syncs per batch and a
    profile of 4 pairs (kernel time per pair over the pair's time: the
    device busy share). The postprocessor's share is the decode's time
    (`decode_card_vs_cpu`) over the pair's."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli.predict_and_save import (
        Normalizer, export_txts, main as predict_main, predict, upload)
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_dsgn_batch_u8)
    from eval_driving_safety_tpu_torch.ops import nms
    cfg = scale_cfg(scale)
    data = os.path.join(tmp, "kitti")
    split = os.path.join(tmp, "steady.txt")
    with open(split, "w") as f:
        f.write("000001\n000002\n" * 7)
    ckpt = os.path.join(tmp, "raised_bias.pt")
    _, _, out = run_cli(["--data_path", data, "--split_file", split,
                         "--debug", "--debugnum", "12",
                         "--detector", "dsgn", "--scale", scale,
                         "--device", str(dev), "--ckpt", ckpt,
                         "--result_dir", os.path.join(tmp, "pred_steady")],
                        predict_main)
    batch_ms = [float(m) for m in re.findall(
        r"exported 1 frames \(([\d.]+) ms\)", out)]
    check(len(batch_ms) == 12, f"steady-state batches {batch_ms}")
    pair_ms_cli = float(np.median(batch_ms[2:]))

    model = raised_bias_weights(cfg, ckpt).to(dev).requires_grad_(False)
    model.eval()
    norm = Normalizer(cfg, dev)
    ds = KittiStereoDataset(data, split_file=split)       # 14 pairs
    res = os.path.join(tmp, "pred_inproc")

    def pairs():
        for b in ds.batches(1, prepare=lambda s: prepare_dsgn_batch_u8(
                s, cfg.input)):
            il, ir, calib = upload(b, dev)
            dets, _ = predict(model, cfg, norm, il, ir, calib)
            export_txts(res, b, dets)
            yield

    with torch.inference_mode():
        it = pairs()
        for _ in range(2):
            next(it)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs = nms.host_syncs["nms_fixpoint"]
        n = 8
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        torch.cuda.synchronize()
        pair_ms = (time.perf_counter() - t0) / n * 1e3
        syncs = (nms.host_syncs["nms_fixpoint"] - syncs) / n
        peak = torch.cuda.max_memory_allocated()
        rows, total_us, port_us = profile_kernels(lambda: list(it))
    kernel_ms = total_us / 1e3 / 4
    rec = {
        "scale": scale, "batch": 1,
        "pairs_per_s": 1e3 / pair_ms_cli, "pair_ms_cli": pair_ms_cli,
        "cli_batch_ms": batch_ms,
        "pair_ms_in_process": pair_ms,
        "peak_device_mem_gib": peak / 2 ** 30,
        "kernel_ms_per_pair": kernel_ms,
        "device_busy_share": kernel_ms / pair_ms,
        "port_kernel_ms_per_pair": port_us / 1e3 / 4,
        "decode_ms": decode_ms,
        "postprocessor_share": decode_ms / pair_ms,
        "host_syncs_per_batch": {"nms_fixpoint_checks": syncs,
                                 "detection_fetch": 1},
        "top_kernels_ms_in_4_pairs": [[k[:70], c, us / 1e3]
                                      for us, k, c in rows[:16]],
        "card": card}
    log(json.dumps({"predict_steady_state": rec}))
    return rec


# --------------------------------------------------------------- phase 7

# the kernels a patch step launches (a forward and the patch's input
# gradient through frozen weights), and a compat model's forward and
# attack iteration (its 3D convs are library convs)
PATCH_PER_STEP = {"psv_warp_fwd": 1, "psv_warp_bwd": 1,
                  "depth_tap_conv_fwd": 8, "depth_tap_conv_bwd": 8}
COMPAT_PER_ITER = {"psv_warp_fwd": 1, "psv_warp_bwd": 1}
COMPAT_PER_PAIR = {"psv_warp_fwd": 1}


def launches_are(launches, per, n):
    """Every kernel launched exactly `per[kernel]` times `n` (0 if not
    in `per`)."""
    return all(v == per.get(k, 0) * n for k, v in launches.items())


def patch_change_ok(save_dir, dim, bound):
    """The (1, 3, dim, dim) patch files of epochs 0..N: each epoch moves
    the patch by at most `bound` and nothing outside the circle moves.
    Returns the largest change of each epoch."""
    import numpy as np
    from eval_driving_safety_tpu_torch.attack.patch import circular_mask
    outside = np.asarray(circular_mask(dim))[..., 0] == 0
    epochs = sorted(int(n[5:]) for n in os.listdir(save_dir)
                    if n.startswith("epoch"))
    patches = []
    for e in epochs:
        raw = np.load(os.path.join(save_dir, f"epoch{e}", "patch.npy"))
        check(raw.shape == (1, 3, dim, dim) and raw.dtype == np.float32
              and np.isfinite(raw).all(),
              f"{save_dir} epoch{e}: patch {raw.shape} {raw.dtype}")
        patches.append(raw[0].transpose(1, 2, 0))
    changes = []
    for e in range(1, len(patches)):
        diff = np.abs(patches[e] - patches[e - 1])
        check(0 < diff.max() <= bound * (1 + 1e-6),
              f"epoch{e}: the patch moved by {diff.max()} (bound {bound})")
        check(not diff[outside].any(), f"epoch{e}: pixels outside the "
              "circle changed")
        changes.append(float(diff.max()))
    return epochs, changes


def patch_cli(tmp, dev, phase2_shapes, scale="paper"):
    """(a) The patch CLI at --scale paper over phase 4's two frames, 2
    epochs of 2 steps per frame: the (1, 3, 77, 77) files, each epoch's
    change within eps x steps and none outside the circle, K1, K2, K3 and
    K4 dx at phase 2's shapes (1, 1, 8, 8 per step) and no weight
    gradient; a second run from the same epoch0 writes the same bytes."""
    import shutil
    from eval_driving_safety_tpu_torch.attack.patch import patch_dim_for
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        main as patch_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    frames, epochs, iters, eps = 2, 2, 2, 8 / 255
    common = ["--data_path", os.path.join(tmp, "kitti"), "--detector", "dsgn",
              "--scale", scale, "--device", str(dev), "--epochs",
              str(epochs), "--iters", str(iters)]
    a, b = os.path.join(tmp, "patch_a"), os.path.join(tmp, "patch_b")
    _cuda.reset_launches()
    t_a, _, out = run_cli(common + ["--save_dir", a], patch_main)
    launches, shapes = dict(_cuda.launches), dict(_cuda.launch_shapes)
    steps = epochs * frames * iters
    check(launches_are(launches, PATCH_PER_STEP, steps),
          f"patch CLI launches {launches} in {steps} steps, expected "
          f"{PATCH_PER_STEP} per step and no weight gradient")
    check({(k, s) for k, s, _ in shapes} == phase2_shapes
          and {dt for _, _, dt in shapes} == {"bfloat16"},
          f"patch CLI launch shapes {sorted(shapes)} != phase-2 shapes")
    losses = [float(v) for v in re.findall(r"avg loss (\S+)", out)]
    check(len(losses) == epochs and all(map(math.isfinite, losses)),
          f"patch CLI losses {losses}")
    dim = patch_dim_for(scale_cfg(scale).height, 0.2)
    check(f"patch dim {dim} (radius {dim // 2})" in out, "patch dim")
    _, changes = patch_change_ok(a, dim, eps * iters * frames)
    shutil.copytree(os.path.join(a, "epoch0"), os.path.join(b, "epoch0"))
    t_b, _, _ = run_cli(common + ["--save_dir", b], patch_main)
    for e in range(1, epochs + 1):
        rel = os.path.join(f"epoch{e}", "patch.npy")
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            check(fa.read() == fb.read(), f"{rel}: two patch runs differ")
    log(json.dumps({"patch_cli": {
        "scale": scale, "frames": frames, "epochs": epochs,
        "iters": iters, "steps": steps, "run_s": t_a, "rerun_s": t_b,
        "epoch_losses": losses, "epoch_max_change": changes,
        "launches": launches, "patch_dim": dim}}))
    return launches, steps


def tiny_frames(b=1):
    import numpy as np
    rng = np.random.RandomState(0)
    il = rng.randint(0, 256, (b, 96, 320, 3)).astype(np.uint8)
    ir = np.clip(np.roll(il.astype(int), -6, axis=2)
                 + rng.randint(-8, 9, il.shape), 0, 255).astype(np.uint8)
    calib = [np.full((b,), v, np.float32) for v in (180.0, 0.54, 160.0,
                                                    48.0)]
    boxes = np.zeros((b, 4, 8), np.float32)
    boxes[:, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    return il, ir, calib, boxes


def card_vs_cpu(name, run, per, dev):
    """`run(device)` -> (loss, [gradients]) on the CPU and the card: loss
    within 1e-4 relative, gradients within 1e-3 x their largest (fp32,
    TF32 off: the same arithmetic summed in other orders), and the card
    run launching exactly `per`."""
    from eval_driving_safety_tpu_torch.ops import _cuda
    lc, gc = run("cpu")
    before = dict(_cuda.launches)
    lk, gk = run(dev)
    moved = {k: _cuda.launches[k] - before[k] for k in before}
    check(abs(lk - lc) <= 1e-4 * abs(lc), f"{name}: loss card {lk} cpu {lc}")
    ge = max(max_err(k.cpu(), c) / float(c.abs().max())
             for k, c in zip(gk, gc))
    check(ge <= 1e-3, f"{name}: gradient card vs cpu: rel err {ge:.3g}")
    check(launches_are(moved, per, 1),
          f"{name}: card launches {moved}, expected {per}")
    log(json.dumps({name: {"loss_card": lk, "loss_cpu": lc,
                           "grad_max_rel_err": ge, "launches": moved}}))


def tiny_patch_card_vs_cpu(dev):
    """(b) One patch step of the tiny fp32 DSGN on the card and the CPU,
    the same weights, frames and centres (a right view partly past the
    left edge): loss and patch gradient."""
    import torch
    from eval_driving_safety_tpu_torch.attack.patch import (
        composite_patch_batch, patch_dim_for, patch_update_step)
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        ghost_car_targets
    from eval_driving_safety_tpu_torch.config import (DSGNConfig,
                                                      PatchConfig, replace)
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    cfg = replace(DSGNConfig.tiny(), dtype="float32")
    il, ir, calib, _ = tiny_frames(2)
    cpu_model = DSGN(cfg).init_weights(seed=3).requires_grad_(False)
    d = patch_dim_for(96, 0.2)
    patch = torch.rand(d, d, 3, generator=torch.Generator().manual_seed(4))
    cl = torch.tensor([[60, 150], [70, 40]])
    cr = cl + torch.tensor([0, -64])
    boxes, num = ghost_car_targets(2, PatchConfig())

    def run(device):
        model = cpu_model if device == "cpu" else DSGN(cfg).requires_grad_(
            False)
        if device != "cpu":
            model.load_state_dict(cpu_model.state_dict())
            model.to(device)
        t = lambda a: torch.as_tensor(a).to(device)
        mean, std = t(cfg.input.mean), t(cfg.input.std)
        l01, r01 = u8_to_01(t(il)), u8_to_01(t(ir))

        def loss_fn(a, b):
            out = model((a - mean) / std, (b - mean) / std,
                        *(t(c) for c in calib))
            return dsgn_total_loss(out, torch.zeros(l01.shape[:3],
                                                    device=device),
                                   t(boxes), t(num), cfg)[0]
        p = t(patch).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(
            composite_patch_batch(l01, p, cl),
            composite_patch_batch(r01, p, cr)), p)
        new, loss = patch_update_step(loss_fn, t(patch), l01, r01, cl, cr,
                                      alpha=1e3, eps=8 / 255)
        check(bool(torch.isfinite(new).all()) and float(
            (new - t(patch)).abs().max()) <= 8 / 255 + 1e-6,
              f"{device}: the patch step moved beyond eps")
        return float(loss), [g.cpu()]
    card_vs_cpu("tiny_patch_step_card_vs_cpu", run,
                {k: 2 * v for k, v in PATCH_PER_STEP.items()}, dev)


def patch_steady_state(tmp, dev, card, scale="paper"):
    """(c) Steady-state patch step at --scale paper, batch 1 (composite,
    forward, patch gradient, clamp), as the CLI runs it on phase 4's
    first frame, and a profile of one."""
    import torch
    from eval_driving_safety_tpu_torch.attack.patch import (
        patch_dim_for, patch_update_step)
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        ghost_car_targets
    from eval_driving_safety_tpu_torch.config import PatchConfig
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_dsgn_batch_u8, u8_to_01)
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    cfg = scale_cfg(scale)
    model = DSGN(cfg).init_weights(0).to(dev).requires_grad_(False)
    b = prepare_dsgn_batch_u8([KittiStereoDataset(os.path.join(
        tmp, "kitti")).get(0)], cfg.input)
    t = lambda a: torch.as_tensor(a).to(dev)
    il, ir = u8_to_01(t(b["im_left_u8"])), u8_to_01(t(b["im_right_u8"]))
    calib = [t(b[k]) for k in ("f_u", "baseline", "c_u", "c_v")]
    mean, std = t(cfg.input.mean), t(cfg.input.std)
    boxes, num = (t(x) for x in ghost_car_targets(1, PatchConfig()))
    depth = torch.zeros(il.shape[:3], device=dev)
    d = patch_dim_for(cfg.height, 0.2)
    cl = torch.tensor([[3 * cfg.height // 4, cfg.width // 2]])
    cr = cl + torch.tensor([0, -64])

    def loss_fn(a, c):
        out = model((a - mean) / std, (c - mean) / std, *calib)
        return dsgn_total_loss(out, depth, boxes, num, cfg)[0]

    patch = torch.zeros(d, d, 3, device=dev)

    def steps(n):
        nonlocal patch
        for _ in range(n):
            patch, loss = patch_update_step(loss_fn, patch, il, ir, cl, cr,
                                            alpha=1e3, eps=8 / 255)
        return loss

    steps(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    loss = steps(n)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    check(math.isfinite(float(loss)), "steady-state patch loss")
    peak = torch.cuda.max_memory_allocated()
    rows, total_us, port_us = profile_kernels(lambda: steps(1))
    rec = {"scale": scale, "batch": 1,
           "patch_step_ms": per_step * 1e3,
           "patch_steps_per_s": 1.0 / per_step,
           "peak_device_mem_gib": peak / 2 ** 30,
           "step_kernel_ms": total_us / 1e3,
           "device_busy_share": (total_us / 1e3) / (per_step * 1e3),
           "port_kernel_ms": port_us / 1e3,
           "top_kernels_ms": [[k[:70], c, us / 1e3]
                              for us, k, c in rows[:16]],
           "card": card}
    log(json.dumps({"patch_steady_state": rec}))


def random_compat_weights(cfg, arch, seed=0):
    """The compat model with seeded weights and, as a trained checkpoint
    has them, BatchNorm statistics, scales and shifts drawn at random."""
    import torch
    from eval_driving_safety_tpu_torch.models.dsgn_compat import (
        BatchNorm, DSGNCompat)
    model = DSGNCompat(cfg, arch).init_weights(seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.normal_(1.0, 0.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model


def write_compat_tar(path, cfg, arch):
    """A random checkpoint in the published layout: {"state_dict":
    {"module." + key: tensor}}, with BatchNorm's num_batches_tracked."""
    import torch
    sd = random_compat_weights(cfg, arch).state_dict()
    out = {f"module.{k}": v for k, v in sd.items()}
    for k in sd:
        if k.endswith(".running_var"):
            out[f"module.{k[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(1000)
    torch.save({"state_dict": out}, path)


def compat_clis(tmp, dev, scale="paper"):
    """(d) A random checkpoint at the upstream default arch in the
    published layout, read by the attack CLI (1 frame, 2 iterations), the
    predict CLI (6 pairs) and the patch CLI (1 epoch of 2 frames, 2 steps
    each) at --scale paper: no key left unmapped; K1 once per forward, K2
    once per backward, nothing else of the port."""
    import numpy as np
    from eval_driving_safety_tpu_torch.attack.patch import patch_dim_for
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        main as patch_main
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.models.dsgn_compat import \
        DSGNCompatArch
    from eval_driving_safety_tpu_torch.ops import _cuda
    cfg = scale_cfg(scale)
    tar = os.path.join(tmp, "finetune_53.tar")
    write_compat_tar(tar, cfg, DSGNCompatArch())
    data = os.path.join(tmp, "kitti")
    common = ["--data_path", data, "--detector", "dsgn", "--scale", scale,
              "--device", str(dev), "--ckpt", tar]
    rec = {}
    _cuda.reset_launches()
    t, losses, out = run_cli(common + [
        "--iter", "2", "--debug", "--debugnum", "1", "--out_prefix",
        os.path.join(tmp, "compat_adv", "dsgn_pgd")])
    check("upstream-compat model" in out and "unmapped 0" in out,
          f"compat import: {out[:600]}")
    check(len(losses) == 1 and all(map(math.isfinite, losses[0])),
          f"compat attack losses {losses}")
    rec["attack"] = {"run_s": t, "iters": 2, "losses": losses,
                     "launches": dict(_cuda.launches)}
    check(launches_are(_cuda.launches, COMPAT_PER_ITER, 2),
          f"compat attack launches {rec['attack']['launches']}")
    split = os.path.join(tmp, "compat_split.txt")
    with open(split, "w") as f:
        f.write("000001\n000002\n" * 3)
    _cuda.reset_launches()
    t, _, out = run_cli(common + ["--split_file", split, "--result_dir",
                                  os.path.join(tmp, "compat_pred")],
                        predict_main)
    batch_ms = [float(m) for m in re.findall(
        r"exported 1 frames \(([\d.]+) ms\)", out)]
    check(len(batch_ms) == 6, f"compat predict batches {batch_ms}")
    predict_layout_ok(os.path.join(tmp, "compat_pred"), ["000001", "000002"],
                      cfg)
    rec["predict"] = {"run_s": t, "pairs": 6, "batch_ms": batch_ms,
                      "pairs_per_s": 1e3 / float(np.median(batch_ms[2:])),
                      "launches": dict(_cuda.launches)}
    check(launches_are(_cuda.launches, COMPAT_PER_PAIR, 6),
          f"compat predict launches {rec['predict']['launches']}")
    _cuda.reset_launches()
    t, _, out = run_cli(common + ["--epochs", "1", "--iters", "2",
                                  "--save_dir",
                                  os.path.join(tmp, "compat_patch")],
                        patch_main)
    rec["patch"] = {"run_s": t, "steps": 4,
                    "launches": dict(_cuda.launches)}
    check(launches_are(_cuda.launches, COMPAT_PER_ITER, 4),
          f"compat patch launches {rec['patch']['launches']}")
    patch_change_ok(os.path.join(tmp, "compat_patch"),
                    patch_dim_for(cfg.height, 0.2), 8 / 255 * 4)
    log(json.dumps({"compat_clis": rec}))
    return rec, tar


def tiny_compat_card_vs_cpu(dev):
    """(e) The tiny compat model (tiny arch, tiny geometry, fp32) on the
    card and the CPU: the attack loss and its input gradients."""
    import torch
    from eval_driving_safety_tpu_torch.config import DSGNConfig, replace
    from eval_driving_safety_tpu_torch.models.dsgn_compat import (
        DSGNCompat, DSGNCompatArch)
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    cfg = replace(DSGNConfig.tiny(), dtype="float32")
    arch = DSGNCompatArch.tiny()
    cpu_model = random_compat_weights(cfg, arch, seed=3).requires_grad_(False)
    il, ir, calib, boxes = tiny_frames()

    def run(device):
        model = cpu_model if device == "cpu" else DSGNCompat(
            cfg, arch).requires_grad_(False)
        if device != "cpu":
            model.load_state_dict(cpu_model.state_dict())
            model.to(device)
        t = lambda a: torch.as_tensor(a).to(device)
        mean, std = t(cfg.input.mean) * 255, t(cfg.input.std) * 255
        xl, xr = (t(a).float().requires_grad_(True) for a in (il, ir))
        out = model((xl - mean) / std, (xr - mean) / std,
                    *(t(c) for c in calib))
        depth = torch.full(xl.shape[:3], 20.0, device=device)
        loss = dsgn_total_loss(out, depth, t(boxes), t([1]), cfg)[0]
        return float(loss.detach()), [g.cpu() for g in
                                      torch.autograd.grad(loss, (xl, xr))]
    card_vs_cpu("tiny_compat_card_vs_cpu", run, COMPAT_PER_ITER, dev)


def conv_device_ms(fn):
    """Device time of one call of `fn` in library convolutions, by the
    rank of their input: the kernels under `aten::convolution` (forward,
    transposed ones included) and `aten::convolution_backward` whose
    first input is 5-D (3D convs) or 4-D (2D convs). cuDNN names its 2D
    and 3D kernels alike, so the kernel rows alone cannot tell them
    apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"conv3d_ms": 0.0, "conv2d_ms": 0.0}
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.key in ("aten::convolution", "aten::convolution_backward") \
                and ev.input_shapes and len(ev.input_shapes[0]) in (4, 5):
            key = "conv3d_ms" if len(ev.input_shapes[0]) == 5 else \
                "conv2d_ms"
            out[key] += ev.device_time_total / 1e3
    return out


def compat_steady_state(tar, dev, card, scale="paper"):
    """(f) Steady-state attack iteration of the compat model at --scale
    paper on the checkpoint of (d), and a profile of one: the port's
    kernels' time, and the cuDNN 3D and 2D convs' (`conv_device_ms`)."""
    import torch
    from eval_driving_safety_tpu_torch.utils.torch_import import \
        load_dsgn_checkpoint
    cfg = scale_cfg(scale)
    model, _ = load_dsgn_checkpoint(tar, cfg)
    model = model.to(dev).requires_grad_(False).eval()
    ss, attack = steady_attack(model, cfg, dev, n=3)
    rows, total_us, port_us = profile_kernels(lambda: attack(1))
    convs = conv_device_ms(lambda: attack(1))
    rec = {"scale": scale, **ss, "profiled_kernel_ms": total_us / 1e3,
           "device_busy_share": (total_us / 1e3) / ss["attack_iter_ms"],
           "port_kernel_ms": port_us / 1e3, **convs,
           "conv3d_share_of_kernel_time": convs["conv3d_ms"] * 1e3
           / max(total_us, 1e-9),
           "top_kernels_ms": [[k[:90], c, us / 1e3]
                              for us, k, c in rows[:20]],
           "card": card}
    log(json.dumps({"compat_steady_state": rec}))
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

    # 4. the slice at paper scale; 6. predict over its attacked frames
    # (in its directory), then the attack's steady state; 7. the patch
    # attack over its frames, and the compat model on a checkpoint in the
    # published layout
    phase2 = {(k, s) for k, s, dt in per if dt == full.dtype}
    fwd_shapes = {(k, s) for k, s in phase2 if k in PREDICT_PER_PAIR}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, shapes, widths, n_iters = the_slice(tmp, card, dev)
        p_launches = predict_cli(tmp, dev, fwd_shapes)
        predict_patch_modes(tmp, dev)
        decode_ms = decode_card_vs_cpu(tmp, full, dev)
        torch.cuda.empty_cache()
        predict_steady_state(tmp, dev, card, decode_ms)
        torch.cuda.empty_cache()
        patch_launches, patch_steps = patch_cli(tmp, dev, phase2)
        tiny_patch_card_vs_cpu(dev)
        patch_steady_state(tmp, dev, card)
        torch.cuda.empty_cache()
        compat, tar = compat_clis(tmp, dev)
        tiny_compat_card_vs_cpu(dev)
        torch.cuda.empty_cache()
        compat_steady_state(tar, dev, card)
    torch.cuda.empty_cache()
    steady_state(full, dev, card)

    # the slice launched each kernel at exactly the shapes phase 2 timed
    # (all in the model's dtype), the same number of times per iteration
    ran = {(k, s) for k, s, _ in shapes}
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
        # 6. predict at DSGNConfig() on the last checkpoint
        predict_on_checkpoint(tmp, dev, {(k, s) for k, s, _ in timed_t
                                         if k in PREDICT_PER_PAIR})
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
            # the predict path: the forward kernels only
            "predict_launches": p_launches[name],
            "launches_per_predict_pair": PREDICT_PER_PAIR.get(name, 0),
            # phase 7: the patch step at --scale paper, and the compat
            # model's attack iteration and predicted pair
            "launches_per_patch_step": patch_launches[name] / patch_steps,
            "launches_per_compat_attack_iter":
                compat["attack"]["launches"][name] / compat["attack"][
                    "iters"],
            "launches_per_compat_predict_pair":
                compat["predict"]["launches"][name] / compat["predict"][
                    "pairs"],
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
