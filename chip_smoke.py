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
     queued behind a sleep kernel, utils/cuda_timing.py); hold the
     depth-tap conv (forward and dx) in bf16 and fp32 at the edges of
     its kernels' tiles and runs of planes, the fp32 kernels bit for bit
     from call to call, and on misaligned views; time the
     weight-gradient kernel alone (not on the attack path; phase 5 runs
     it in training); hold K1 and K2
     (forward and backward PSV warp) at the edges of their design: other
     channel counts and access widths, ragged and long rows, per-image
     and out-of-range disparities, the unfused warp, misaligned views and
     a non-contiguous gradient; and hold and time K1-K4 at the model
     axis's per-rank shapes of phase 15 and at the tiny config's shapes
     of phase 16 (bf16);
  3. run the tiny model in fp32 on the card and on the CPU with the same
     weights and inputs and compare the loss and the input gradients;
  4. run the attack CLI at --scale paper on two seeded KITTI-layout frames
     (3 iterations), check the output sweep, that the kernels were
     launched at the shapes phase 2 checked, K1 and K2 with 16-byte
     accesses only, without alignment or contiguity copies, that
     both runs reached the native host stages only (replay_sweep_u8 once
     a side in the signs run, png_store_write for every PNG, the numpy
     replays and the zlib writer never) and that --transfer full writes
     the same PNGs; time the
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
  8. the Stereo R-CNN attack (cli/pgd_attack.py --detector srcnn), which
     launches none of the port's kernels: (a) the CLI at
     StereoRCNNConfig() (ResNet-101 FPN, 600 x 1984, bf16, s2d) over
     phase 4's frames, 3 iterations: the sweep at network scale, the
     native integer host replay (the log says "native/int"; the runs
     reach the native host stages only, as in phase 4), a rerun with the
     same packed signs and bytes, --transfer full with the same bytes;
     (b) the tiny model in fp32 on the card and on the CPU; (c) the
     steady-state iteration, its profile and ROIAlign's share
     (`srcnn_steady_state`); (d) one --fp32 run, which must turn TF32
     off; (e) the sweeps' host stages on phase 4's first frame pair at
     paper size (DSGN 384 x 1248, Stereo R-CNN 600 x 1984, 3 iterations,
     seeded 2-bit and 1-bit signs; no model run): native
     (attack/replay_native.py, data/png_store.py) against the plain numpy
     and zlib versions, every pair of outputs equal, a white frame's PNG
     decoded whole, each stage's median host ms, printed
     as the `replay` line after the DSGN steady state with the card's ms
     per pair of each detector's sweep.
  9. Stereo R-CNN predict (cli/predict_and_save.py --detector srcnn)
     and its patch attack (cli/patch_attack.py --detector srcnn), at
     StereoRCNNConfig() in bf16, batch 1, neither launching a port
     kernel: (a) predict on planted weights (NMS keeps 50 boxes a frame)
     over phase 8's attacked sweep and phase 4's clean frames, with AP,
     input PNGs and panels, twice with byte-identical txts; (b) one fetch
     of outputs decoded with the dense alignment on the card and on the
     CPU (the same kept boxes; the same picks, or picks whose errors lie
     within 1e-5 relative); (c) the steady-state predicted pair on those
     weights and on the same heads over the RPN's own box deltas
     (`srcnn_predict_steady_state`: pairs/s, busy share, peak memory,
     the decode's share, host syncs per batch); (d) the patch CLI over
     phase 4's frames, 2 epochs of 2 steps per frame, each epoch within
     eps x steps and the circle, within the per-channel bounds, a rerun
     from the same epoch0 writing the same bytes; (e) one tiny fp32
     patch step on the card and on the CPU; (f) the steady-state patch
     step (`srcnn_patch_steady_state`); (g) predict with (d)'s patch in
     each --patch_mode, the card's composite equal to the CPU's; (h) one
     --fp32 predict, which must turn TF32 off.
  10. the scene classifiers at the published widths (ResNet-50 and
     VGG-16 at 224, batch 32, fp32 with TF32 off), none launching a port
     kernel: (a) crop_images over phase 4's frames, then 64 seeded crops
     and their CSVs; (b) train_classifier for each task, 5 epochs, each
     with finite losses and an epoch5/ checkpoint whose backbone equals
     its seeded init bit for bit; (c) validate_classifier on each; (d)
     classify_split over phase 4's frames on planted heads (every score
     far from 0.5, both outcomes) on the card and on the CPU: the same
     files, every score within 1e-4; (e) one train step of each on the
     card and on the CPU with the same dropout mask; (f)
     `classifier_steady_state`: train steps/s at batch 32, classify_split
     frames/s, busy share, peak memory.
  11. Stereo R-CNN training (cli/train_detector.py --detector srcnn) at
     StereoRCNNConfig() fp32 and the published checkpoint's layout, none
     launching a port kernel: (a) 2 epochs over phase 4's frames with a
     checkpoint each and a resumed third: finite losses, an `uncert` that
     moves, FrozenBatchNorm statistics bit for bit at their init; the
     srcnn attack and predict CLIs on the last checkpoint; (b) one tiny
     fp32 training step on the card and on the CPU with the same draws;
     (c) the steady-state step (`srcnn_train_step`: steps/s, busy share,
     peak memory, top kernels); (d) a random state dict in the upstream
     published layout, read by the srcnn attack, predict and patch CLIs
     with 0 unmapped keys.
  12. the safety stage (convert_gt_scenarios, convert_scenarios,
     plan_motion, check_collision, eval, plot_scenario, plot_solution),
     on the host, launching no port kernel: (a) phase 10's classify_split
     folders (phase 4's GT labels, bucketed and coded) to GT scenarios,
     and the card's own detections (phase 6's DSGN txts on the clean and
     the attacked frames, phase 9's Stereo R-CNN txts on both) converted,
     planned, checked with --check_all and scored with eval --json: every
     file written, every rate in [0, 1], collision.txt's count equal to
     num_collisions (a rate of 0 is a result); (b) a seeded synthetic
     `kitti_labeled` tree at the reference corpus's size (319 static, 69
     dynamic and 168 road-dynamic frames, 0-12 vehicles each among
     pedestrians and cyclists) and detections derived from it with
     seeded misses and jitter, through the same chain, which must give
     solved and unsolved scenarios and colliding and clean solutions; (c)
     a rerun of (b)'s chain writing the same scenarios, solutions and
     collision.txt byte for byte and the same metrics; (d)
     plot_scenario, plot_solution and check_collision --plot on two of
     (b)'s scenarios, each PNG decoding at 600 x 1000; (e) the port's
     launch counts unchanged over the phase; (f) `safety_pipeline`: the
     scenarios, solved and colliding, the five metrics, each stage's
     seconds, planning ms a scenario (median, p90, max) and expansions,
     all on the card machine's host CPU.
  13. the batch split over torch.distributed (parallel/sharding.py) on
     phase 4's two frames at --batch 2: the DSGN signs sweep and patch at
     --scale paper and the Stereo R-CNN sweep at StereoRCNNConfig(), each
     as one process and as two gloo ranks sharing the card (the card's
     machine has one H100; NCCL refuses two ranks on one device, and no
     speed-up can be shown): every rank exits 0, every file is written
     once, by the rank of its frame, the ranks' patches are the same
     bits, and each DSGN rank launches K1-K4 at phase 2's (per-rank)
     shapes; whether the files equal the one process's is printed, with
     the differing pixels and where this process's first step differs
     between the batch of 2 and each row alone with the batch's
     normalizers (`split`).
  14. the JAX DSGN trainer's orbax checkpoint at DSGNConfig.tiny(),
     committed under tests/torch_fixtures/orbax_dsgn_tiny/ (no JAX on this
     machine: utils.orbax_read reads it through the system's libzstd): (a)
     every leaf equal to the SHA-256 digests the JAX package's restore
     gave; (b) the attack CLI on it at --scale tiny, 1 iteration,
     launching K1-K4 dx at the tiny config's shapes and no weight
     gradient; (c) the training CLI resumed from a copy of it, starting at
     epoch N+1 with the optax state's step count and writing
     epoch{N+1}/checkpoint.pt; `orbax`: the library's path and version,
     the read's host ms and MB/s on this machine's CPU.
  15. the model axis (parallel/volume.py): DSGN's plane-sweep volume
     split by depth plane over two gloo ranks sharing the card, mesh
     (1, 2), on phase 4's first frame: (a) one PGD step and one patch
     step of the fast DSGN at DSGNConfig.full() bf16, as one process and
     as the two ranks: the loss (and the patch step's) within 2^-7
     relative, every depth map within 2^-7 x the largest, at most a
     quarter of the image-gradient signs flipped, the two ranks' results
     the same bits; each rank launches K1, K2, K3 and K4 dx at its
     per-rank shapes (48 planes for K1/K2; 50, 26 and 14 planes for K3/K4
     dx, the voxel layers whole) and no weight gradient, and those new
     shapes are held against the plain versions here; (b) the compat
     model at the upstream default arch the same way (its depth map by
     the mean error, 2^-10, and at most 5% of the pixels past 2^-7),
     launching K1 and K2 once a step and nothing else of the port; (c)
     parallel.dryrun at world 4 on the (2, 2) mesh at --scale dryrun;
     `model_axis`: each run's step time, the collectives' bytes and host
     ms a step, peak memory per rank, the ranks' kernels a step, and
     phase 18 (e)'s remat step.
  16. the DSGN full story (examples/end_to_end_demo.py): overfit the
     detector on a synthetic planted-car scene (400 Adam steps), detect,
     PGD-attack (8 iterations), plan on both detections and
     collision-check against the true scene: (a) at DSGNConfig.tiny()
     twice, with the same METRICS bits and trained weights, under
     tests/test_dsgn_end_to_end.py's conditions (the car found, the clean
     plan clear, the loss ascends, the attacked plan collides or fails);
     (b) at DSGNConfig() once: the car found within 3 m, the clean plan
     clear, the loss ascends (the flip printed); (c) each story launching
     the kernels at phase 5's counts a training step plus phase 4's a
     PGD iteration and phase 6's a detection, at shapes phase 2 held (the
     tiny config's too); `demo`: each story's stage times, losses,
     detections and metrics.
  17. the Stereo R-CNN full story (examples/srcnn_end_to_end.py), fp32
     with TF32 off, launching no port kernel: (a) at
     StereoRCNNConfig.tiny() on the driver's schedule (probes from step
     1,250 every 250, up to 2,500), held to
     tests/test_srcnn_end_to_end.py's five conditions (clean score >=
     0.5, IoU > 0.3, the attack's loss up by 10, within eps, the attacked
     score down by 0.1); (b) its first 100 steps again: the losses and
     the weights' SHA-256 the same bits; (c) at StereoRCNNConfig()
     capped at 250 steps, probed at the cap and attacked: finite losses,
     the loss below step 0's, the attack ascending within eps (the probe
     and both scores printed); (d) the launch counts unchanged;
     `srcnn_demo`: each story's losses at its logged steps and probes,
     stage ms, peak memory and outcome.
  18. the CLIs' options no earlier phase sets, over phase 4's frames at
     --scale paper (run after phase 15, in its directory): (a) the attack
     CLI with --remat (3 iterations) writing the PNG bytes and losses of
     a run without it, launching K1 1, K2 1, K3 13 (the hourglass's five
     stride-1 blocks again in the backward pass) and K4 dx 8 an
     iteration at phase 2's shapes; (b) the patch CLI with --remat, 1
     epoch of 2 steps: patch.npy's bytes; (c) the attack CLI on phase
     7's .tar with --remat: the same bytes, K1 and K2 once an iteration;
     (d) predict with --remat under inference mode: the same txts and
     launches, no new warning; (e) in phase 15, one PGD step with remat
     on each model of the model axis: every rank's loss and image
     gradients bit for bit those without it, K3 8 + 5 at the rank's
     shapes, the halo exchanges counted; (f) --objective depth_divergence
     and depth_shift (--depth_shift_m 5) with make_depth_gt's maps, each
     twice: losses finite and ascending, nonzero signs, the same bytes,
     K1 1, K2 1, K3 8, K4 dx 5 an iteration (nothing of the 3DGV/BEV
     branch reaches the loss); without --depth_dir every iteration writes
     the clean frames; the tiny fp32 first step under each on the card
     and on the CPU; (g) one iteration under --debug_nans with (a)'s
     bytes; `remat_steady_state`: the steady-state iteration without and
     with remat, in turns (ms, kernel ms, busy share, peak memory);
     `options`: each run's seconds, losses and launches, the iteration
     under anomaly mode, the phase's seconds.
Each phase's seconds are printed (`phase_s`). The line before the last
is the kernels' JSON record (the four kernels
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


def check_depthconv(cfg, dtype_name, dev, per, wgrad, shapes=None):
    """Hold K3, K4 dx and the weight gradient against their plain versions
    at `shapes` (B, D, N, C, F) (those of `cfg`'s forward by default),
    and time them beside the library call."""
    import torch
    import torch.nn.functional as F
    from eval_driving_safety_tpu_torch.ops.depthconv import (
        depth_tap_conv, reference_depth_tap_conv,
        reference_depth_tap_conv_wgrad)
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(1)
    isz = torch.finfo(dt).bits // 8
    for b, d, n, c, f in shapes or depthconv_shapes(cfg):
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


# (B, D, N, C, F) of the depth-tap conv's edge checks, per dtype. bf16:
# the tensor-core kernels' tiles (64 pixels; D chunks of 4 planes, 3 at
# width 64). fp32: the CUDA-core kernel's pixel tiles (128 pixels at
# output widths up to 32, 64 at 64) and its runs of planes (one wave of
# blocks, each an equal run of the items: one-plane runs, runs that end
# in one plane of a tile, runs that cross tiles, D = 1 across tiles).
DEPTHCONV_EDGES = {
    "bfloat16": [(1, 1, 35, 32, 32), (2, 2, 35, 64, 32), (1, 3, 65, 32, 64),
                 (1, 13, 35, 64, 32), (2, 13, 65, 8, 16), (1, 5, 65, 16, 8),
                 (1, 4, 129, 64, 64), (1, 2, 1, 8, 8), (1, 9, 2561, 32, 32),
                 (1, 7, 130, 16, 64)],
    "float32": [(1, 1, 129, 32, 32), (2, 2, 65, 64, 64), (1, 3, 129, 16, 8),
                (1, 13, 65, 64, 32), (2, 13, 129, 8, 16), (1, 5, 257, 32, 64),
                (1, 2, 1, 8, 8), (1, 7, 130, 16, 64), (2, 40, 2561, 32, 32),
                (1, 48, 1000, 64, 64), (1, 1, 60000, 32, 32)],
}


def f32_runs(b, d, n, tile, blocks):
    """The planes of each run of each block of an fp32 launch: the items
    (b, tile, plane) cut into `blocks` equal contiguous ranges."""
    items = b * -(-n // tile) * d
    out = []
    for s in range(blocks):
        i, i1, runs = s * items // blocks, (s + 1) * items // blocks, []
        while i < i1:
            d0 = i % d
            runs.append(min(d, d0 + i1 - i) - d0)
            i += runs[-1]
        out.append(runs)
    return out


def check_depthconv_edges(dev):
    """The depth-tap conv, forward and dx, against the plain version at
    the edges of each dtype's kernels (`DEPTHCONV_EDGES`): N ragged
    against the pixel tile (one past it), D of 1, 2, 3, D split across
    blocks with a last part of one plane, C != F, widths of 8 (padded to
    the MMA's K of 16 in bf16), ReLU on and off, B = 2; in fp32 two calls
    give the same bits and the cases cover the launch geometry's runs.
    Then misaligned views in each dtype."""
    import torch
    from eval_driving_safety_tpu_torch.ops.depthconv import (
        depth_tap_conv, f32_geometry, reference_depth_tap_conv)
    for dtype_name, seed in (("bfloat16", 2), ("float32", 6)):
        dt, rtol = getattr(torch, dtype_name), RTOL[dtype_name]
        g = torch.Generator(device=dev).manual_seed(seed)
        cases = DEPTHCONV_EDGES[dtype_name]
        worst, runs = 0.0, {"one_plane": 0, "longer": 0, "across_tiles": 0,
                            "one_past_tile": 0}
        for b, d, n, c, f in cases:
            if dtype_name == "float32":
                for dx in (False, True):
                    tile, blocks = f32_geometry(b, d, n, c, f, dx)
                    per_block = f32_runs(b, d, n, tile, blocks)
                    flat = [r for rs in per_block for r in rs]
                    runs["one_plane"] += flat.count(1)
                    runs["longer"] += sum(r > 1 for r in flat)
                    runs["across_tiles"] += sum(len(rs) > 1
                                                for rs in per_block)
                    runs["one_past_tile"] += n % tile == 1
            x = (torch.randn(b, d, n, 1, c, device=dev, generator=g)
                 * 0.5).to(dt)
            w = (torch.randn(3, c, f, device=dev, generator=g)
                 / c ** 0.5).to(dt)
            inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(dt)
            off = (0.1 * torch.randn(f, device=dev, generator=g)).to(dt)
            dy = torch.randn(b, d, n, 1, f, device=dev, generator=g).to(dt)
            for relu in (True, False):
                tag = f"{(b, d, n, c, f)} relu={relu} {dtype_name}"
                xk = x.clone().requires_grad_(True)
                xp = x.clone().requires_grad_(True)
                y = depth_tap_conv(xk, w, inv, off, relu)
                y_ref = reference_depth_tap_conv(xp, w, inv, off, relu)
                compare(f"depth_tap_conv_fwd edge {tag}", y, y_ref, rtol)
                # dx under the kernel's own ReLU mask, as in
                # check_depthconv
                dm = dy * (y.detach() > 0) if relu else dy
                yl = reference_depth_tap_conv(xp, w, inv, off, relu=False)
                (dxk,) = torch.autograd.grad(y, xk, dy, retain_graph=True)
                (dxp,) = torch.autograd.grad(yl, xp, dm)
                compare(f"depth_tap_conv_bwd dx edge {tag}", dxk, dxp, rtol)
                if dtype_name == "float32":
                    (dx2,) = torch.autograd.grad(y, xk, dy)
                    y2 = depth_tap_conv(x, w, inv, off, relu)
                    check(torch.equal(y2, y.detach()) and
                          torch.equal(dx2, dxk),
                          f"depth_tap_conv edge {tag}: two calls differ")
                for a_, r_ in ((y, y_ref), (dxk, dxp)):
                    worst = max(worst, max_err(a_, r_) / max(
                        float(r_.detach().float().abs().max()), 1e-30))
        copies = misaligned_views(dev, dtype_name)
        rec = {"cases": len(cases) * 2, "max_err_over_max_ref": worst,
               "rtol": rtol, "misaligned_view_copies": copies}
        if dtype_name == "float32":
            check(all(runs.values()), f"fp32 edge cases miss a run kind: "
                  f"{runs}")
            rec.update(bit_for_bit_repeats=True, runs=runs)
        short = {"bfloat16": "bf16", "float32": "fp32"}[dtype_name]
        log(json.dumps({f"depthconv_{short}_edges": rec}))


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


def misaligned_views(dev, dtype_name="bfloat16"):
    """The depth-tap conv on x, w and dy given as misaligned views: the
    wrapper copies each once, counted, and forward and dx equal those of
    aligned inputs bit for bit. Returns the copies counted."""
    import torch
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.ops.depthconv import depth_tap_conv
    dt = getattr(torch, dtype_name)
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
    check(copies == 3, f"misaligned x, w, dy: {copies} copies, not 3 "
          f"({dtype_name})")
    check(torch.equal(ym, ya) and torch.equal(dxm, dxa),
          f"misaligned views give other results than aligned inputs "
          f"({dtype_name})")
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
    copies = _cuda.align_copies["depth_tap_conv"]
    lc, glc, grc = run(cpu_model, "cpu")
    lk, glk, grk = run(card_model, dev)
    moved = {k: _cuda.launches[k] - before[k] for k in before}
    check(_cuda.align_copies["depth_tap_conv"] == copies,
          "the tiny fp32 model's inputs to the depth-tap conv needed "
          "alignment copies")
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


@contextlib.contextmanager
def native_host_path():
    """Count the sweep's calls of its native host stages
    (attack.replay_native.replay_sweep_u8, data.png_store.png_store_write)
    and make their plain versions (attack.pgd's replays,
    data.kitti.write_png) raise: a --transfer signs or full sweep must
    reach the native functions only. Yields the counts."""
    import threading
    from eval_driving_safety_tpu_torch.attack import pgd as P
    from eval_driving_safety_tpu_torch.attack import replay_native as R
    from eval_driving_safety_tpu_torch.data import kitti as K
    from eval_driving_safety_tpu_torch.data import png_store as PS
    calls = {"replay_sweep_u8": 0, "png_store_write": 0}
    lock = threading.Lock()
    saved = [(m, n, getattr(m, n)) for m, n in (
        (R, "replay_sweep_u8"), (PS, "png_store_write"),
        (P, "replay_pgd_255"), (P, "replay_pgd_ints"), (P, "replay_pgd"),
        (K, "write_png"))]

    def counted(name, fn):
        def call(*a, **k):
            with lock:
                calls[name] += 1
            return fn(*a, **k)
        return call

    def refused(name):
        def call(*a, **k):
            raise RuntimeError(f"the sweep reached the plain {name}")
        return call
    for m, n, fn in saved:
        setattr(m, n, counted(n, fn) if n in calls else refused(n))
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def native_calls_ok(calls, pairs, iters, replays):
    """Whether a sweep of `pairs` frame pairs and `iters` iterations wrote
    every PNG natively and replayed each side natively `replays` times a
    pair (1 for a signs run, 0 for a full one)."""
    return calls == {"replay_sweep_u8": 2 * pairs * replays,
                     "png_store_write": 2 * pairs * (iters + 1)}


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
    with native_host_path() as native_signs:
        t_signs, losses, _ = run_cli(common + [
            "--out_prefix", os.path.join(tmp, "signs", "dsgn_pgd")])
    launches = dict(_cuda.launches)
    check(native_calls_ok(native_signs, len(ids), iters, 1),
          f"the signs sweep's native host calls {native_signs}")
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
    with native_host_path() as native_full:
        t_full, losses_full, _ = run_cli(common + [
            "--out_prefix", os.path.join(tmp, "full", "dsgn_pgd"),
            "--transfer", "full"])
    check(native_calls_ok(native_full, len(ids), iters, 0),
          f"the full sweep's native host calls {native_full}")
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
        "align_copies": sum(copies.values()),
        "native_host_calls": {"signs": native_signs, "full": native_full},
        "card": card}}))
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
    return ss


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


# --------------------------------------------------------------- phase 8

SRCNN_IDS, SRCNN_ITERS = ["000001", "000002"], 3


def png_dir_bytes(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def sign_digest(fetched):
    """SHA-256 of a fetched packed sign trajectory pair (pl, pr, bits)."""
    import hashlib
    return hashlib.sha256(fetched[0].tobytes() + fetched[1].tobytes()
                          ).hexdigest()


def nonzero_signs(fetched):
    """(nonzero, all) gradient signs of a fetched packed trajectory pair
    (pl, pr, bits): 1-bit planes hold no zero sign (no zero plane was
    needed), 2-bit codes are unpacked and counted."""
    import numpy as np
    from eval_driving_safety_tpu_torch.attack.pgd import unpack_signs
    pl, pr, bits = fetched
    if bits == 1:
        n = 8 * (pl.size + pr.size)
        return n, n
    s = [unpack_signs(p) for p in (pl, pr)]
    return (sum(int(np.count_nonzero(x)) for x in s),
            sum(x.size for x in s))


@contextlib.contextmanager
def recorded_signs(summary=sign_digest):
    """Record `summary` of every packed sign trajectory a sweep's replay
    fetches (data.dataset.fetch_packed_signs, both detectors' CLIs)."""
    from eval_driving_safety_tpu_torch.data import dataset as D
    orig, seen = D.fetch_packed_signs, []

    def fetch(pl, pr):
        res = orig(pl, pr)
        seen.append(summary(res))
        return res
    D.fetch_packed_signs = fetch
    try:
        yield seen
    finally:
        D.fetch_packed_signs = orig


def srcnn_cli(tmp, dev):
    """(a) The attack CLI with --detector srcnn at StereoRCNNConfig()
    (ResNet-101 FPN, 600 x 1984, bf16, s2d stem) over phase 4's two
    frames, 3 iterations, batch 1: the sweep's layout at network scale,
    finite losses, the int32 host replay, no kernel of the port launched,
    a second run with the same packed signs and PNG bytes, and --transfer
    full writing the same PNG bytes."""
    import numpy as np
    from eval_driving_safety_tpu_torch.data.kitti import load_image_u8
    from eval_driving_safety_tpu_torch.ops import _cuda
    common = ["--data_path", os.path.join(tmp, "kitti"), "--detector",
              "srcnn", "--iter", str(SRCNN_ITERS), "--batch", "1",
              "--device", str(dev)]
    runs, signs = {}, {}
    _cuda.reset_launches()
    for name in ("signs", "signs_rerun", "full"):
        extra = ["--transfer", "full"] if name == "full" else []
        with recorded_signs() as seen, native_host_path() as calls:
            t, losses, out = run_cli(common + extra + [
                "--out_prefix", os.path.join(tmp, "srcnn_" + name,
                                             "stereo_rcnn_pgd")])
        runs[name] = {"run_s": t, "losses": losses,
                      "native_host_calls": calls}
        signs[name] = sorted(seen)
        check(len(losses) == len(SRCNN_IDS) and all(
            len(l) == SRCNN_ITERS and all(map(math.isfinite, l))
            for l in losses), f"srcnn {name} run: losses {losses}")
        check(native_calls_ok(calls, len(SRCNN_IDS), SRCNN_ITERS,
                              name != "full"),
              f"srcnn {name} run: native host calls {calls}")
        if name != "full":
            check("host replay path: native/int" in out,
                  f"srcnn {name} run: the native replay was not taken")
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"the Stereo R-CNN attack launched port kernels: {launches}")
    check(len(signs["signs"]) == len(SRCNN_IDS)
          and signs["signs"] == signs["signs_rerun"],
          "two srcnn runs fetched different packed signs")
    files = {k: png_dir_bytes(os.path.join(tmp, "srcnn_" + k))
             for k in runs}
    want = {os.path.join(f"stereo_rcnn_pgd_iters_{k}", sub, fid + ".png")
            for k in range(SRCNN_ITERS + 1)
            for sub in ("image_2", "image_3") for fid in SRCNN_IDS}
    check(set(files["signs"]) == want, f"srcnn sweep files "
          f"{sorted(files['signs'])}")
    for other in ("signs_rerun", "full"):
        check(files[other] == files["signs"],
              f"srcnn --transfer {other}: PNG bytes differ from the signs "
              "run's")
    for fid in SRCNN_IDS:
        rel = os.path.join("stereo_rcnn_pgd_iters_{}", "image_2",
                           fid + ".png")
        root = os.path.join(tmp, "srcnn_signs")
        clean = load_image_u8(os.path.join(root, rel.format(0)))
        # 375 x 1242 frames resized to 600 rows: 1987 columns, cropped
        check(clean.shape == (600, 1984, 3), f"srcnn frame {clean.shape}")
        for k in range(1, SRCNN_ITERS + 1):
            adv = load_image_u8(os.path.join(root, rel.format(k)))
            diff = int(np.abs(adv.astype(int) - clean.astype(int)).max())
            check(0 < diff <= 77, f"srcnn {fid} iter {k}: |adv - clean| "
                  f"{diff} (eps 76.5 px)")
    log(json.dumps({"srcnn_cli": {
        "config": "StereoRCNNConfig() bf16 s2d", "frames": len(SRCNN_IDS),
        "iters": SRCNN_ITERS, **runs, "launches": launches,
        "signs_sha256": signs["signs"]}}))
    return launches


def tiny_srcnn_card_vs_cpu(dev):
    """(b) The tiny Stereo R-CNN in fp32 (TF32 off) on the card and the
    CPU: the same weights, inputs, gt and sampler draws; the total loss
    and both input gradients, and no kernel of the port launched."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, make_gt_batch, total_attack_loss)
    from eval_driving_safety_tpu_torch.data.kitti import (Calibration,
                                                          KittiObject)
    cfg = StereoRCNNConfig.tiny()
    cpu_model = StereoRCNN(cfg).init_weights(seed=3).requires_grad_(False)
    il, ir, _, _ = tiny_frames(1)
    means = np.asarray(cfg.input.pixel_means_bgr, np.float32)
    il = il[..., ::-1].astype(np.float32) - means
    ir = ir[..., ::-1].astype(np.float32) - means
    objs = [KittiObject.from_line(
        "Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 18.0 "
        "0.4")]
    gt = make_gt_batch([objs], [Calibration.default(180.0, 160.0, 48.0)],
                       cfg)
    draws = cpu_model.sample_draws(1, torch.Generator().manual_seed(7))
    uncert = torch.tensor([0.3, -0.2, 0.1, 0.5, -0.4, 0.2])

    def run(device):
        model = cpu_model if device == "cpu" else StereoRCNN(
            cfg).requires_grad_(False)
        if device != "cpu":
            model.load_state_dict(cpu_model.state_dict())
            model.to(device)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)
        a, b = t(il).requires_grad_(True), t(ir).requires_grad_(True)
        out = model(a, b, gt={k: v.to(device) for k, v in gt.items()},
                    draws=type(draws)(*(d.to(device) for d in draws)),
                    mode="attack")
        total = total_attack_loss(out.losses, uncert.to(device))
        ga, gb = torch.autograd.grad(total, (a, b))
        return float(total.detach()), [ga.cpu(), gb.cpu()]
    card_vs_cpu("tiny_srcnn_card_vs_cpu", run, {}, dev)


def roi_align_device_ms(fn):
    """Device time of one call of `fn` in ROIAlign's forward and backward
    (the kernels under their `record_function` ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"roi_align_fwd": 0.0, "roi_align_bwd": 0.0}
    for ev in prof.key_averages():
        if ev.key in out and ev.device_type.name == "CPU":
            out[ev.key] += ev.device_time_total / 1e3
    return out


def srcnn_steady_state(tmp, dev, card):
    """(c) The steady-state Stereo R-CNN attack iteration at
    StereoRCNNConfig() in bf16 on phase 4's first frame, as the CLI runs
    it (v-space ingest, the six-term loss, input gradients, sign step):
    its time, peak memory, a profile of one iteration (kernel time, busy
    share, top kernels, ROIAlign's share) and the fixpoint NMS's host
    syncs per iteration."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack.pgd import pgd_attack
    from eval_driving_safety_tpu_torch.models.common import cast_matmul_params
    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, srcnn_cleanv_device)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, make_gt_batch, total_attack_loss)
    from eval_driving_safety_tpu_torch.ops import nms
    cfg = StereoRCNNConfig(dtype="bfloat16", stem_method="s2d")
    model = StereoRCNN(cfg).init_weights(0).to(dev).requires_grad_(False)
    cast_matmul_params(model)
    ds = KittiStereoDataset(os.path.join(tmp, "kitti"))
    b = prepare_srcnn_batch_u8([ds.get(0)], cfg.input)
    gt = make_gt_batch(b["objects"], b["calibs"], cfg,
                       image_scale=b["scales"], device=dev)
    put = lambda a: torch.as_tensor(a).to(dev)
    w = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w", "wmask")}
    clean_l = srcnn_cleanv_device(w, put(b["im_left_u8"]))
    clean_r = srcnn_cleanv_device(w, put(b["im_right_u8"]))
    K = float(b["den_h"][0]) * float(b["den_w"][0])
    cb = put(b["c255"])[:, None, None, None]
    means = put(np.asarray(cfg.input.pixel_means_bgr, np.float32))
    draws = model.sample_draws(1, torch.Generator(device=dev).manual_seed(11))
    uncert = torch.zeros(6, device=dev)

    def loss_fn(a, c):
        out = model(a * cb - means, c * cb - means, gt=gt, draws=draws,
                    mode="attack")
        return total_attack_loss(out.losses, uncert)

    def attack(k):
        return pgd_attack(loss_fn, clean_l, clean_r, num_iters=k, alpha=K,
                          eps=76.5 * K, clip_min=0.0, clip_max=255.0 * K,
                          collect="signs1")

    n = 5
    attack(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs = nms.host_syncs["nms_fixpoint"]
    t0 = time.perf_counter()
    res = attack(n)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / n
    syncs = (nms.host_syncs["nms_fixpoint"] - syncs) / n
    check(bool(torch.isfinite(res.losses).all()), "srcnn steady losses")
    peak = torch.cuda.max_memory_allocated()
    rows, total_us, port_us = profile_kernels(lambda: attack(1))
    roi = roi_align_device_ms(lambda: attack(1))
    roi_ms = sum(roi.values())
    rec = {"config": "StereoRCNNConfig() bf16 s2d", "batch": 1,
           "attack_iter_ms": per_iter * 1e3,
           "attack_iters_per_s": 1.0 / per_iter,
           "peak_device_mem_gib": peak / 2 ** 30,
           "profiled_kernel_ms": total_us / 1e3,
           "kernel_launches_per_iter": sum(c for _, _, c in rows),
           "device_busy_share": (total_us / 1e3) / (per_iter * 1e3),
           "port_kernel_ms": port_us / 1e3,
           "roi_align_fwd_ms": roi["roi_align_fwd"],
           "roi_align_bwd_ms": roi["roi_align_bwd"],
           "roi_align_share_of_kernel_time": roi_ms * 1e3
           / max(total_us, 1e-9),
           "nms_fixpoint_syncs_per_iter": syncs,
           "top_kernels_ms": [[k[:90], c, us / 1e3]
                              for us, k, c in rows[:16]],
           "card": card}
    log(json.dumps({"srcnn_steady_state": rec}))
    check(port_us == 0, "the srcnn attack iteration ran a port kernel")
    return rec


def srcnn_fp32_cli(tmp, dev):
    """(d) The srcnn CLI once with --fp32 (1 iteration, 1 frame): finite
    losses, TF32 turned off by the CLI, no port kernel launched."""
    import torch
    from eval_driving_safety_tpu_torch.ops import _cuda
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _cuda.reset_launches()
    t, losses, _ = run_cli([
        "--data_path", os.path.join(tmp, "kitti"), "--detector", "srcnn",
        "--fp32", "--iter", "1", "--debug", "--debugnum", "1",
        "--device", str(dev), "--out_prefix",
        os.path.join(tmp, "srcnn_fp32", "stereo_rcnn_pgd")])
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "the --fp32 srcnn CLI left TF32 on")
    check(len(losses) == 1 and all(map(math.isfinite, losses[0])),
          f"srcnn --fp32 losses {losses}")
    check(not any(_cuda.launches.values()),
          f"the --fp32 srcnn CLI launched {dict(_cuda.launches)}")
    log(json.dumps({"srcnn_fp32_cli": {"run_s": t, "losses": losses}}))


def stereo_rcnn_phase(tmp, dev, card):
    """Phase 8 over phase 4's frames in `tmp`; the launches of (a) and
    the steady-state record of (c)."""
    import torch
    launches = srcnn_cli(tmp, dev)
    tiny_srcnn_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    steady = srcnn_steady_state(tmp, dev, card)
    torch.cuda.empty_cache()
    srcnn_fp32_cli(tmp, dev)
    torch.cuda.empty_cache()
    return launches, steady


def host_ms(fn, reps=5):
    """Median host time of `fn` over `reps` calls (perf_counter), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def o3_builds(build_dir):
    """Inside the block the sweep's libraries (attack.replay_native,
    data.png_store) are built and loaded at -O3 alone, into build_dir."""
    from eval_driving_safety_tpu_torch.attack import replay_native as R
    from eval_driving_safety_tpu_torch.data import png_store as PS
    saved = [(m, m.CXX_FLAGS, m.BUILD_DIR, m._lib) for m in (R, PS)]
    for m in (R, PS):
        m.CXX_FLAGS, m.BUILD_DIR, m._lib = ("-O3", "-shared", "-fPIC"), \
            build_dir, None
    try:
        yield
    finally:
        for m, flags, build, lib in saved:
            m.CXX_FLAGS, m.BUILD_DIR, m._lib = flags, build, lib


def replay_host_stages(tmp):
    """The sweeps' host stages at paper size on phase 4's first frame
    pair, native (attack.replay_native, data.png_store) against the plain
    versions the sweeps ran before (attack.pgd's numpy replays, the numpy
    resize and quantize, data.kitti.write_png at level 0): every pair of
    outputs equal byte for byte, and each stage's median host ms. Seeded signs,
    SRCNN_ITERS iterations, 2-bit codes with zeros and the 1-bit plane
    of zero-free signs; no model runs."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack import pgd as P
    from eval_driving_safety_tpu_torch.attack import replay_native as R
    from eval_driving_safety_tpu_torch.config import (DSGNInputConfig,
                                                      SRCNNInputConfig)
    from eval_driving_safety_tpu_torch.data import dataset as D
    from eval_driving_safety_tpu_torch.data import kitti as K
    from eval_driving_safety_tpu_torch.data import png_store as PS
    sample = D.KittiStereoDataset(os.path.join(tmp, "kitti")).get(0)
    rng = np.random.RandomState(15)
    iters = SRCNN_ITERS
    equal, ms = {}, {}

    def packed_signs(shape):
        s2 = torch.from_numpy(rng.randint(-1, 2, (iters, *shape)).astype(
            np.float32))
        s1 = torch.from_numpy(rng.choice(np.float32([-1, 1]),
                                         (iters, *shape)))
        return {2: P.pack_signs(s2).numpy(), 1: P.pack_bits(s1 > 0).numpy()}

    def two_bit(p, bits):
        return p if bits == 2 else P.signs1_to_packed2(p)

    def same(name, a, b):
        equal[name] = bool(np.array_equal(a, b))
        check(equal[name], f"replay line: native and plain {name} differ")

    def as_bytes(out):
        """A stage's output (arrays, or a file's bytes) as one u8 array."""
        if isinstance(out, bytes):
            return np.frombuffer(out, np.uint8)
        return np.concatenate([np.ravel(a).view(np.uint8) for a in out])
    # stage -> (its native call, the calls one makes, its output's bytes
    # [, the file it writes])
    tuned = {}

    # DSGN 255-space, frames padded to 384 x 1248, both sides
    bd = D.prepare_dsgn_batch_u8([sample], DSGNInputConfig())
    cl, cr = bd["im_left_u8"], bd["im_right_u8"]
    pl, pr = packed_signs(cl.shape), packed_signs(cr.shape)
    dsgn_frames = None
    for bits in (2, 1):
        kw = dict(alpha2=2, eps2=153, max2=510, c255=1.0,
                  flip_channels=False, bits=bits)

        def nat(kw=kw, sl=pl[bits], sr=pr[bits]):
            return (R.replay_sweep_u8(cl.astype(np.int32), sl, **kw),
                    R.replay_sweep_u8(cr.astype(np.int32), sr, **kw))

        def plain():
            fr = list(P.replay_pgd_255(cl, cr, two_bit(pl[bits], bits),
                                       two_bit(pr[bits], bits), eps=76.5))
            return (np.stack([a for a, _ in fr]), np.stack([b for _, b in fr]))
        got, want = nat(), plain()
        same(f"dsgn_replay_b{bits}", np.stack(got), np.stack(want))
        dsgn_frames = got
        tuned[f"dsgn_replay_b{bits}"] = (nat, 2 * iters, as_bytes(got))
        ms[f"dsgn_replay_b{bits}"] = {
            "native": host_ms(nat) / (2 * iters),
            "plain": host_ms(plain) / (2 * iters)}

    # Stereo R-CNN v-space at 600 x 1984: the resize with the iteration-0
    # quantize, then the replay, both sides
    bs = D.prepare_srcnn_batch_u8([sample], SRCNNInputConfig())
    c255 = bs["c255"]

    def resize_nat():
        return D.srcnn_cleanv_q0_host(bs)

    def resize_plain():
        vl, vr = D.srcnn_cleanv_host(bs)
        return (vl, vr, D.quantize_v_rgb_u8(vl.astype(np.float32), c255),
                D.quantize_v_rgb_u8(vr.astype(np.float32), c255))
    got, want = resize_nat(), resize_plain()
    for name, a, b in zip(("v_left", "v_right", "q0_left", "q0_right"),
                          got, want):
        same(f"srcnn_resize_{name}", a, b)
    vl, vr, q0l = got[0], got[1], got[2]
    tuned["srcnn_resize_q0"] = (resize_nat, 2, as_bytes(got))
    ms["srcnn_resize_q0"] = {"native": host_ms(resize_nat) / 2,
                             "plain": host_ms(resize_plain) / 2}
    k = bs["den_h"].astype(np.int64) * bs["den_w"]
    a2, e2, m2 = 2 * k, 153 * k, 510 * k
    pl, pr = packed_signs(vl.shape), packed_signs(vr.shape)
    srcnn_frames = None
    for bits in (2, 1):
        kw = dict(alpha2=a2, eps2=e2, max2=m2, c255=c255, flip_channels=True,
                  bits=bits)

        def nat(kw=kw, sl=pl[bits], sr=pr[bits]):
            return (R.replay_sweep_u8(vl, sl, **kw),
                    R.replay_sweep_u8(vr, sr, **kw))

        def plain():
            half = np.float32(0.5)
            fr = [(D.quantize_v_rgb_u8(a.astype(np.float32) * half, c255),
                   D.quantize_v_rgb_u8(b.astype(np.float32) * half, c255))
                  for a, b in P.replay_pgd_ints(
                      vl * 2, vr * 2, two_bit(pl[bits], bits),
                      two_bit(pr[bits], bits), alpha2=a2, eps2=e2,
                      clip_max2=m2)]
            return (np.stack([a for a, _ in fr]), np.stack([b for _, b in fr]))
        got, want = nat(), plain()
        same(f"srcnn_replay_b{bits}", np.stack(got), np.stack(want))
        srcnn_frames = got
        tuned[f"srcnn_replay_b{bits}"] = (nat, 2 * iters, as_bytes(got))
        ms[f"srcnn_replay_b{bits}"] = {
            "native": host_ms(nat) / (2 * iters),
            "plain": host_ms(plain) / (2 * iters)}

    # the PNG writes: a DSGN frame cropped to 375 x 1242 in place, and a
    # Stereo R-CNN frame at 600 x 1984; the plain writer takes a copy, as
    # save_image did
    out_dir = os.path.join(tmp, "replay_png")
    os.makedirs(out_dir, exist_ok=True)
    h, w = sample.orig_hw
    sizes = {}
    for name, img in (("png_dsgn", dsgn_frames[0][-1, 0, :h, :w]),
                      ("png_srcnn", srcnn_frames[0][-1, 0])):
        nat_path = os.path.join(out_dir, name + "_native.png")
        plain_path = os.path.join(out_dir, name + "_zlib.png")
        def write(path=nat_path, img=img):
            PS.png_store_write(path, img)
        ms[name] = {
            "native": host_ms(write),
            "plain": host_ms(lambda: K.write_png(
                plain_path, np.ascontiguousarray(img), 0))}
        decoded = []
        for path in (nat_path, plain_path):
            with open(path, "rb") as f:
                decoded.append(K.decode_png_rgb(f.read()))
        with open(nat_path, "rb") as f:
            tuned[name] = (write, 1, as_bytes(f.read()), nat_path)
        same(name + "_pixels", decoded[0], img)
        same(name + "_pixels_zlib", decoded[1], img)
        sizes[name] = {"shape": list(img.shape),
                       "bytes_native": os.path.getsize(nat_path),
                       "bytes_zlib": os.path.getsize(plain_path)}
    check(q0l.shape[1:3] == (600, 1984), f"srcnn frame {q0l.shape}")
    # a saturated frame: every scanline sums to the most adler32 can hold
    white = np.full((600, 1984, 3), 255, np.uint8)
    PS.png_store_write(os.path.join(out_dir, "white.png"), white)
    with open(os.path.join(out_dir, "white.png"), "rb") as f:
        same("png_white_pixels", K.decode_png_rgb(f.read()), white)

    # the same native stages built at -O3 alone, the collision core's
    # flags: what -march=native (native_build.TUNED_FLAGS) buys on this
    # host, for the same bytes
    with o3_builds(os.path.join(tmp, "build_o3")):
        for name, (fn, per, ref, *path) in tuned.items():
            out = fn()
            if path:
                with open(path[0], "rb") as f:
                    out = f.read()
            same(name + "_o3", as_bytes(out), ref)
            ms[name]["native_o3"] = host_ms(fn) / per

    # one pair's host work at SRCNN_ITERS iterations, the sweep's common
    # case (1-bit planes): DSGN replays both sides and writes (iters + 1)
    # PNG pairs; Stereo R-CNN also resizes both sides
    n_png = 2 * (iters + 1)
    pair = {}
    for way in ("native", "native_o3", "plain"):
        pair[way] = {
            "dsgn": 2 * iters * ms["dsgn_replay_b1"][way]
            + n_png * ms["png_dsgn"][way],
            "srcnn": 2 * ms["srcnn_resize_q0"][way]
            + 2 * iters * ms["srcnn_replay_b1"][way]
            + n_png * ms["png_srcnn"][way]}
    return {"equal": equal, "host_ms": ms, "png": sizes,
            "host_ms_per_pair": pair, "iters": iters}


def replay_record(host, dsgn_steady, srcnn_steady, card):
    """The `replay` line: the host stages of `replay_host_stages` beside
    the card's time per pair at the same iterations, from each detector's
    steady-state attack iteration."""
    iters = host["iters"]
    card_ms = {"dsgn": dsgn_steady["attack_iter_ms"] * iters,
               "srcnn": srcnn_steady["attack_iter_ms"] * iters}
    return {**host, "card_ms_per_pair": card_ms,
            "host_per_card": {
                way: {d: host["host_ms_per_pair"][way][d] / card_ms[d]
                      for d in card_ms}
                for way in ("native", "native_o3", "plain")},
            "clock": "host perf_counter, median of 5: host times on the "
                     "card machine's CPU, not the card's",
            "card": card}


# --------------------------------------------------------------- phase 9

SRCNN_PATCH_EPOCHS, SRCNN_PATCH_ITERS, SRCNN_PATCH_EPS = 2, 2, 0.1


def srcnn_cfg(tiny=False, dtype="bfloat16"):
    """StereoRCNNConfig() (or the tiny config, for a rehearsal on the
    CPU) in `dtype`."""
    from eval_driving_safety_tpu_torch.config import (StereoRCNNConfig,
                                                      replace)
    return replace(StereoRCNNConfig.tiny() if tiny else StereoRCNNConfig(),
                   dtype=dtype)


def planted_srcnn_weights(cfg, path, anchors=True):
    """Seeded weights whose heads are planted so that predict exports
    boxes: the rcnn head's Car bias raised to +3 over a kernel scaled by
    0.01 (every proposal scores as a car, so NMS keeps its 50), zero box
    deltas but the right box shifted by -0.2 of its width (a plausible
    disparity), a constant car from the dimension-orientation head, and,
    with `anchors`, the RPN's box conv zeroed, so the proposals are the
    anchors themselves and the 3D solve gets boxes it can succeed on.
    Saved as a state dict for --ckpt."""
    import torch
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
    model = StereoRCNN(cfg).init_weights(0)
    rc = model.rcnn
    with torch.no_grad():
        rc.cls_score.weight.mul_(0.01)
        rc.cls_score.bias.copy_(torch.tensor([0.0, 3.0]))
        rc.bbox_pred.weight.zero_()
        rc.bbox_pred.bias.copy_(torch.tensor([0.0] * 10 + [-2.0, 0.0]))
        rc.dim_orien_pred.weight.zero_()
        rc.dim_orien_pred.bias.copy_(
            torch.tensor([0.0] * 5 + [1.5, 1.7, 4.0, 0.2, 0.98]))
        if anchors:
            model.rpn.rpn_box.weight.zero_()
    torch.save(model.state_dict(), path)


def load_srcnn(cfg, ckpt, dev):
    """The model the CLIs make from `ckpt` (None: a seeded init)."""
    import argparse
    from eval_driving_safety_tpu_torch.cli.common import make_srcnn_model
    with contextlib.redirect_stdout(io.StringIO()):
        return make_srcnn_model(argparse.Namespace(ckpt=ckpt), cfg, dev)


@contextlib.contextmanager
def recorded_calls(module, name):
    """Record (args, kwargs, result) of every call of `module.name`."""
    orig, calls = getattr(module, name), []

    def wrapper(*a, **k):
        res = orig(*a, **k)
        calls.append((a, k, res))
        return res
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def srcnn_predict_inputs(tmp):
    """Phase 9's predict inputs: phase 8's last attacked sweep (frames at
    network scale) and phase 4's clean frames, as --image_{2,3}_dir
    flags."""
    adv = os.path.join(tmp, "srcnn_signs",
                       f"stereo_rcnn_pgd_iters_{SRCNN_ITERS}")
    return {"attacked": ["--image_2_dir", os.path.join(adv, "image_2"),
                         "--image_3_dir", os.path.join(adv, "image_3")],
            "clean": []}


def txt_bytes(res):
    out = {}
    for fid in SRCNN_IDS:
        with open(os.path.join(res, "data", fid + ".txt"), "rb") as f:
            out[fid] = f.read()
    return out


def srcnn_predict_cli(tmp, dev, tiny=False):
    """(a) The predict CLI with --detector srcnn at StereoRCNNConfig()
    (bf16) on the planted weights over phase 8's attacked sweep and phase
    4's clean frames, with --eval_ap, --save_input_dir and --plot: the
    layout at network scale, 16-field KITTI lines, the AP table, a second
    run writing the same txt bytes, and no port kernel launched."""
    import numpy as np
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.data.kitti import load_image_u8
    from eval_driving_safety_tpu_torch.ops import _cuda
    cfg = srcnn_cfg(tiny)
    ckpt = os.path.join(tmp, "srcnn_planted.pt")
    planted_srcnn_weights(cfg, ckpt)
    base = ["--data_path", os.path.join(tmp, "kitti"), "--detector",
            "srcnn", "--device", str(dev), "--ckpt", ckpt] + (
                ["--tiny"] if tiny else [])
    _cuda.reset_launches()
    rec, pairs = {}, 0
    for name, dirs in srcnn_predict_inputs(tmp).items():
        res = os.path.join(tmp, f"srcnn_pred_{name}")
        inputs = os.path.join(res, "inputs")
        t_a, _, out = run_cli(base + dirs + [
            "--result_dir", res, "--eval_ap", "--plot", "--save_input_dir",
            inputs], predict_main)
        check("AP (Car, moderate, IoU 0.70)" in out,
              f"srcnn predict {name}: {out[-400:]}")
        predict_layout_ok(res, SRCNN_IDS, cfg, plot=True)
        for fid in SRCNN_IDS:
            for sub in ("image_2", "image_3"):
                img = load_image_u8(os.path.join(inputs, sub, fid + ".png"))
                check(img.shape == (cfg.input.height, cfg.input.width, 3),
                      f"srcnn predict {name} input {sub}/{fid} {img.shape}")
        t_b, _, _ = run_cli(base + dirs + ["--result_dir", res + "_rerun"],
                            predict_main)
        first, second = txt_bytes(res), txt_bytes(res + "_rerun")
        check(first == second, f"srcnn predict {name}: two runs wrote "
              "different txts")
        with open(os.path.join(res, "metrics.jsonl")) as f:
            ap = json.loads(f.read().splitlines()[-1])
        rec[name] = {"run_s": t_a, "rerun_s": t_b,
                     "detections": sum(v.count(b"\n")
                                       for v in first.values()),
                     "ap_moderate": {k: ap[k] for k in ("ap_bbox", "ap_bev",
                                                        "ap_3d")}}
        pairs += 2 * len(SRCNN_IDS)
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"the Stereo R-CNN predict CLI launched port kernels: {launches}")
    check(all(r["detections"] > 0 for r in rec.values()),
          f"srcnn predict exported no detection: {rec}")
    log(json.dumps({"srcnn_predict_cli": {
        "config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} "
                  f"{cfg.dtype}, planted heads", "pairs": pairs, **rec,
        "launches": launches}}))
    return launches, pairs


def srcnn_decode_card_vs_cpu(tmp, dev, tiny=False):
    """(b) One fetch of the planted model's outputs on phase 8's first
    attacked pair, decoded with the dense alignment on the card and on
    the CPU: NMS keeps max_detections boxes, the same on both; the
    alignment's success flags are equal and so are its picks, but where
    the CPU's errors of the two picks differ by less than 1e-5 relative
    (counted); the detections of equal picks are equal. Returns the
    decode's time on the card, its fetch included."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, srcnn_clean01_device)
    from eval_driving_safety_tpu_torch.inference import \
        stereo_rcnn_predict as SP
    from eval_driving_safety_tpu_torch.ops.dense_align import \
        candidate_errors
    cfg = srcnn_cfg(tiny)
    model, _ = load_srcnn(cfg, os.path.join(tmp, "srcnn_planted.pt"), dev)
    flags = srcnn_predict_inputs(tmp)["attacked"]
    ds = KittiStereoDataset(os.path.join(tmp, "kitti"), image_2_dir=flags[1],
                            image_3_dir=flags[3])
    b = prepare_srcnn_batch_u8([ds.get(0)], cfg.input)
    put = lambda a: torch.as_tensor(a).to(dev)
    w = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w", "wmask", "c")}
    means = put(np.asarray(cfg.input.pixel_means_bgr, np.float32))
    kw = dict(image_hw=b["orig_hw"][0], image_scale=float(b["scales"][0]))
    with torch.inference_mode():
        il = srcnn_clean01_device(w, put(b["im_left_u8"])) * 255.0 - means
        ir = srcnn_clean01_device(w, put(b["im_right_u8"])) * 255.0 - means
        out = model(il, ir, mode="infer")
        host = SP.fetch_outputs(out)
        runs = {}
        for where, imgs in (("card", (il[0], ir[0])),
                            ("cpu", (il[0].cpu(), ir[0].cpu()))):
            with recorded_calls(SP, "nms") as kept, \
                    recorded_calls(SP, "align_disparities") as aligned:
                dets = SP.predict_image(host, *imgs, b["calibs"][0], cfg,
                                        **kw)
            runs[where] = (dets, kept, aligned)
        (dk, kk, ak), (dc, kc, ac) = runs["card"], runs["cpu"]
        kept = [int(r[2][1].sum()) for r in kk]
        check(kept == [cfg.max_detections] and all(
            torch.equal(a[2][0][a[2][1]], c[2][0][c[2][1]])
            for a, c in zip(kk, kc)),
            f"srcnn decode: NMS kept {kept} (card) and "
            f"{[int(r[2][1].sum()) for r in kc]} (cpu)")
        check(len(ak) == len(ac) == 1, f"srcnn decode: {len(ak)} card and "
              f"{len(ac)} cpu alignments")
        (ok_k, d_k), (ok_c, d_c) = ak[0][2], ac[0][2]
        check(torch.equal(ok_k.cpu(), ok_c), "srcnn decode: alignment "
              "success flags differ between card and cpu")
        _, _, err_k = candidate_errors(*ak[0][0])
        _, _, err_c = candidate_errors(*ac[0][0])
        pick_k = torch.argmin(err_k, 1).cpu()
        pick_c = torch.argmin(err_c, 1)
        rows = torch.arange(len(pick_c))
        differ = pick_k != pick_c
        lo = err_c[rows, pick_c]
        gap = (err_c[rows, pick_k] - lo).abs()
        check(bool((gap[differ] <= 1e-5 * lo[differ].abs()).all()),
              f"srcnn decode: the card picked candidates {pick_k[differ]} "
              f"where the cpu picked {pick_c[differ]}, errors "
              f"{gap[differ]} apart")
        check(torch.equal(d_k.cpu()[~differ], d_c[~differ]),
              "srcnn decode: equal picks gave other disparities")
        if not differ.any():
            check(len(dk) == len(dc) and all(
                all(np.array_equal(np.asarray(x[f]), np.asarray(y[f]))
                    for f in x) for x, y in zip(dk, dc)),
                  "srcnn decode: card and cpu detections differ")
        decode_ms = time_ms(lambda: SP.predict_image(
            SP.fetch_outputs(out), il[0], ir[0], b["calibs"][0], cfg, **kw))
    rec = {"kept_by_nms": kept[0], "solved": int(len(ok_c)),
           "aligned": int(ok_c.sum()), "exported": len(dk),
           "differing_picks": int(differ.sum()),
           "disparity_max_abs_diff": float((d_k.cpu() - d_c).abs().max()),
           "decode_ms": decode_ms}
    log(json.dumps({"srcnn_decode_card_vs_cpu": rec}))
    return decode_ms


def srcnn_predict_steady_state(tmp, dev, card, tiny=False):
    """(c) Steady-state Stereo R-CNN predict, batch 1, as the CLI runs it
    (PNG decodes prefetched, uint8 upload, exact resize, forward, one
    fetch, host decode, the alignment on the card, txt writes), for two
    weight sets: the planted ones of (a), whose proposals are the
    anchors, and the same heads over the RPN's own (random) box deltas.
    For each: pairs/s from the CLI's per-batch times over 12 batches of
    phase 4's frames after the first two; the same loop in this process
    for the peak memory, the host syncs per batch, the decode's time
    (fetch, NMS, solves, alignment, after the forward has finished) and
    a profile of 4 pairs (kernel time per pair over the pair's time: the
    busy share)."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, srcnn_clean01_device)
    from eval_driving_safety_tpu_torch.data.kitti import write_detections
    from eval_driving_safety_tpu_torch.inference import \
        stereo_rcnn_predict as SP
    from eval_driving_safety_tpu_torch.ops import nms
    cfg = srcnn_cfg(tiny)
    data = os.path.join(tmp, "kitti")
    split = os.path.join(tmp, "srcnn_steady.txt")
    with open(split, "w") as f:
        f.write("000001\n000002\n" * 7)
    ds = KittiStereoDataset(data, split_file=split)       # 14 pairs
    means = torch.tensor(cfg.input.pixel_means_bgr, device=dev)
    put = lambda a: torch.as_tensor(a).to(dev, non_blocking=True)
    rpn_ckpt = os.path.join(tmp, "srcnn_planted_rpn.pt")
    planted_srcnn_weights(cfg, rpn_ckpt, anchors=False)
    rec = {"config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} "
                     f"{cfg.dtype}", "batch": 1, "card": card}
    for name, ckpt in (("proposals_are_anchors",
                        os.path.join(tmp, "srcnn_planted.pt")),
                       ("rpn_deltas", rpn_ckpt)):
        _, _, out = run_cli(["--data_path", data, "--split_file", split,
                             "--debug", "--debugnum", "12", "--detector",
                             "srcnn", "--device", str(dev), "--ckpt", ckpt,
                             "--result_dir", os.path.join(
                                 tmp, f"srcnn_steady_{name}")]
                            + (["--tiny"] if tiny else []), predict_main)
        batch_ms = [float(m) for m in re.findall(
            r"exported 1 frames \(([\d.]+) ms\)", out)]
        check(len(batch_ms) == 12, f"srcnn steady-state batches {batch_ms}")
        pair_ms_cli = float(np.median(batch_ms[2:]))
        model, _ = load_srcnn(cfg, ckpt, dev)
        res = os.path.join(tmp, f"srcnn_inproc_{name}")
        decode_s, exported = [], []

        def pairs():
            for b in ds.batches(1, prepare=lambda s: prepare_srcnn_batch_u8(
                    s, cfg.input)):
                w = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                            "wmask", "c")}
                il = srcnn_clean01_device(w, put(b["im_left_u8"])) * 255.0 \
                    - means
                ir = srcnn_clean01_device(w, put(b["im_right_u8"])) \
                    * 255.0 - means
                out = model(il, ir, mode="infer")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets = SP.predict_image(
                    SP.fetch_outputs(out), il[0], ir[0], b["calibs"][0], cfg,
                    image_hw=b["orig_hw"][0],
                    image_scale=float(b["scales"][0]))
                decode_s.append(time.perf_counter() - t0)
                exported.append(len(dets))
                write_detections(os.path.join(res, b["frame_ids"][0]
                                              + ".txt"), dets)
                yield

        with torch.inference_mode(), \
                recorded_calls(SP, "align_disparities") as aligned:
            it = pairs()
            for _ in range(2):
                next(it)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            syncs, n_align = nms.host_syncs["nms_fixpoint"], len(aligned)
            del decode_s[:]
            n = 8
            t0 = time.perf_counter()
            for _ in range(n):
                next(it)
            torch.cuda.synchronize()
            pair_ms = (time.perf_counter() - t0) / n * 1e3
            syncs = (nms.host_syncs["nms_fixpoint"] - syncs) / n
            n_align = (len(aligned) - n_align) / n
            decode_ms = float(np.median(decode_s)) * 1e3
            peak = torch.cuda.max_memory_allocated()
            rows, total_us, port_us = profile_kernels(lambda: list(it))
        kernel_ms = total_us / 1e3 / 4
        rec[name] = {
            "pairs_per_s": 1e3 / pair_ms_cli, "pair_ms_cli": pair_ms_cli,
            "cli_batch_ms": batch_ms, "pair_ms_in_process": pair_ms,
            "exported_per_pair": float(np.mean(exported)),
            "peak_device_mem_gib": peak / 2 ** 30,
            "kernel_ms_per_pair": kernel_ms,
            "kernel_launches_per_pair": sum(c for _, _, c in rows) / 4,
            "device_busy_share": kernel_ms / pair_ms,
            "port_kernel_ms_per_pair": port_us / 1e3 / 4,
            "decode_ms": decode_ms, "decode_share": decode_ms / pair_ms,
            "host_syncs_per_batch": {"nms_fixpoint_checks": syncs,
                                     "output_fetch": 1,
                                     "alignment_fetches": n_align},
            "top_kernels_ms_in_4_pairs": [[k[:70], c, us / 1e3]
                                          for us, k, c in rows[:12]]}
        check(port_us == 0, "the srcnn predict ran a port kernel")
        del model
        torch.cuda.empty_cache()
    log(json.dumps({"srcnn_predict_steady_state": rec}))
    return rec


def srcnn_patch_cli(tmp, dev, tiny=False):
    """(d) The patch CLI with --detector srcnn at StereoRCNNConfig()
    (bf16, s2d) over phase 4's two frames, 2 epochs of 2 steps per frame:
    the (1, 3, 61, 61) files, each epoch's change within eps x steps and
    none outside the circle, every patch within the per-channel pixel
    bounds, no port kernel launched, and a second run from the same
    epoch0 writing the same bytes. Returns the launches, the steps and
    the last patch's path."""
    import numpy as np
    from eval_driving_safety_tpu_torch.attack.patch import patch_dim_for
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        main as patch_main
    from eval_driving_safety_tpu_torch.data.dataset import srcnn_clip_bounds
    from eval_driving_safety_tpu_torch.ops import _cuda
    import shutil
    cfg = srcnn_cfg(tiny)
    frames = len(SRCNN_IDS)
    epochs, iters, eps = SRCNN_PATCH_EPOCHS, SRCNN_PATCH_ITERS, \
        SRCNN_PATCH_EPS
    common = ["--data_path", os.path.join(tmp, "kitti"), "--detector",
              "srcnn", "--device", str(dev), "--epochs", str(epochs),
              "--iters", str(iters)] + (["--tiny"] if tiny else [])
    a = os.path.join(tmp, "srcnn_patch_a")
    b = os.path.join(tmp, "srcnn_patch_b")
    _cuda.reset_launches()
    t_a, _, out = run_cli(common + ["--save_dir", a], patch_main)
    launches = dict(_cuda.launches)
    steps = epochs * frames * iters
    check(not any(launches.values()),
          f"the Stereo R-CNN patch CLI launched port kernels: {launches}")
    losses = [float(v) for v in re.findall(r"avg loss (\S+)", out)]
    check(len(losses) == epochs and all(map(math.isfinite, losses)),
          f"srcnn patch CLI losses {losses}")
    dim = patch_dim_for(cfg.input.height, 0.1)
    check(f"patch dim {dim} (radius {dim // 2})" in out, "srcnn patch dim")
    _, changes = patch_change_ok(a, dim, eps * iters * frames)
    lo, hi = srcnn_clip_bounds(cfg.input)
    for e in range(1, epochs + 1):
        p = np.load(os.path.join(a, f"epoch{e}", "patch.npy"))[0]
        check(all(lo[c] <= p[c].min() and p[c].max() <= hi[c]
                  for c in range(3)),
              f"srcnn patch epoch{e} outside the per-channel bounds")
    shutil.copytree(os.path.join(a, "epoch0"), os.path.join(b, "epoch0"))
    t_b, _, _ = run_cli(common + ["--save_dir", b], patch_main)
    for e in range(1, epochs + 1):
        rel = os.path.join(f"epoch{e}", "patch.npy")
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            check(fa.read() == fb.read(), f"srcnn {rel}: two patch runs "
                  "differ")
    log(json.dumps({"srcnn_patch_cli": {
        "config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} "
                  f"{cfg.dtype} s2d", "frames": frames, "epochs": epochs,
        "iters": iters, "steps": steps, "run_s": t_a, "rerun_s": t_b,
        "epoch_losses": losses, "epoch_max_change": changes,
        "launches": launches, "patch_dim": dim}}))
    return launches, steps, os.path.join(a, f"epoch{epochs}", "patch.npy")


def tiny_srcnn_patch_card_vs_cpu(dev):
    """(e) One patch step of the tiny fp32 Stereo R-CNN (TF32 off) on the
    card and the CPU, the same weights, frames, centres, targets, sampler
    draws and uncert: loss, patch gradient, and the new patch within the
    per-channel bounds."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack.patch import (
        composite_patch_batch, patch_update_step)
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        _srcnn_patch_targets
    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    from eval_driving_safety_tpu_torch.data.dataset import srcnn_clip_bounds
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, total_attack_loss)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = StereoRCNNConfig.tiny()
    cpu_model = StereoRCNN(cfg).init_weights(seed=3).requires_grad_(False)
    il, ir, _, _ = tiny_frames(2)
    means = np.asarray(cfg.input.pixel_means_bgr, np.float32)
    il = il[..., ::-1].astype(np.float32) - means
    ir = ir[..., ::-1].astype(np.float32) - means
    lo, hi = srcnn_clip_bounds(cfg.input)
    d, radius = 9, 4
    rng = np.random.RandomState(4)
    patch = (lo + (hi - lo) * rng.rand(d, d, 3)).astype(np.float32)
    cl = torch.tensor([[60, 150], [70, 40]])
    cr = cl + torch.tensor([0, -64])
    gt = _srcnn_patch_targets(2, cfg, radius, cl, cr)
    draws = cpu_model.sample_draws(2, torch.Generator().manual_seed(17))
    uncert = torch.tensor([0.3, -0.2, 0.1, 0.5, -0.4, 0.2])

    def run(device):
        model = cpu_model if device == "cpu" else StereoRCNN(
            cfg).requires_grad_(False)
        if device != "cpu":
            model.load_state_dict(cpu_model.state_dict())
            model.to(device)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)
        left, right = t(il), t(ir)
        gt_d = {k: v.to(device) for k, v in gt.items()}
        draws_d = type(draws)(*(x.to(device) for x in draws))

        def loss_fn(a, b):
            out = model(a, b, gt=gt_d, draws=draws_d, mode="attack")
            return total_attack_loss(out.losses, uncert.to(device))
        p = t(patch).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(
            composite_patch_batch(left, p, cl),
            composite_patch_batch(right, p, cr)), p)
        new, loss = patch_update_step(loss_fn, t(patch), left, right, cl, cr,
                                      alpha=1e3, eps=0.1, pixel_min=t(lo),
                                      pixel_max=t(hi))
        new = new.cpu().numpy()
        check(np.isfinite(new).all() and (new >= lo).all()
              and (new <= hi).all()
              and np.abs(new - patch).max() <= 0.1 + 1e-5,
              f"{device}: the srcnn patch step left its bounds")
        return float(loss), [g.cpu()]
    card_vs_cpu("tiny_srcnn_patch_step_card_vs_cpu", run, {}, dev)


def srcnn_patch_steady_state(tmp, dev, card, tiny=False):
    """(f) The steady-state Stereo R-CNN patch step at StereoRCNNConfig()
    (bf16, s2d), batch 1, as the CLI runs it on phase 4's first frame
    (card ingest, composite, the six-term loss toward the patch's box,
    patch gradient, per-channel clamp): steps/s, peak memory, a profile
    of one step (kernel time, busy share, top kernels)."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack.patch import (
        patch_dim_for, patch_update_step)
    from eval_driving_safety_tpu_torch.cli.patch_attack import (
        SRCNN_PATCH_DRAW_SEED, _srcnn_patch_targets)
    from eval_driving_safety_tpu_torch.config import replace
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, srcnn_clean01_device,
        srcnn_clip_bounds)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import \
        total_attack_loss
    cfg = replace(srcnn_cfg(tiny), stem_method="s2d")
    model, uncert = load_srcnn(cfg, None, dev)
    b = prepare_srcnn_batch_u8([KittiStereoDataset(os.path.join(
        tmp, "kitti")).get(0)], cfg.input)
    put = lambda a: torch.as_tensor(a).to(dev)
    w = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w", "wmask", "c")}
    means = put(np.asarray(cfg.input.pixel_means_bgr, np.float32))
    lo, hi = (put(v) for v in srcnn_clip_bounds(cfg.input))
    h, wd = cfg.input.height, cfg.input.width
    d = patch_dim_for(h, 0.1)
    cl = torch.tensor([[3 * h // 4, wd // 2]])
    cr = cl + torch.tensor([0, -64])
    gt = _srcnn_patch_targets(1, cfg, d // 2, cl, cr, dev)
    draws = model.sample_draws(1, torch.Generator(device=dev).manual_seed(
        SRCNN_PATCH_DRAW_SEED))

    def loss_fn(a, c):
        out = model(a, c, gt=gt, draws=draws, mode="attack")
        return total_attack_loss(out.losses, uncert)

    patch = torch.zeros(d, d, 3, device=dev)

    def steps(n):
        nonlocal patch
        il = srcnn_clean01_device(w, put(b["im_left_u8"])) * 255.0 - means
        ir = srcnn_clean01_device(w, put(b["im_right_u8"])) * 255.0 - means
        for _ in range(n):
            patch, loss = patch_update_step(loss_fn, patch, il, ir, cl, cr,
                                            alpha=1e3, eps=0.1,
                                            pixel_min=lo, pixel_max=hi)
        return loss

    steps(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    loss = steps(n)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n
    check(math.isfinite(float(loss)), "steady-state srcnn patch loss")
    peak = torch.cuda.max_memory_allocated()
    rows, total_us, port_us = profile_kernels(lambda: steps(1))
    rec = {"config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} "
                     f"{cfg.dtype} s2d", "batch": 1,
           "patch_step_ms": per_step * 1e3,
           "patch_steps_per_s": 1.0 / per_step,
           "peak_device_mem_gib": peak / 2 ** 30,
           "step_kernel_ms": total_us / 1e3,
           "kernel_launches_per_step": sum(c for _, _, c in rows),
           "device_busy_share": (total_us / 1e3) / (per_step * 1e3),
           "port_kernel_ms": port_us / 1e3,
           "top_kernels_ms": [[k[:70], c, us / 1e3]
                              for us, k, c in rows[:16]],
           "card": card}
    log(json.dumps({"srcnn_patch_steady_state": rec}))
    check(port_us == 0, "the srcnn patch step ran a port kernel")
    return rec


def srcnn_predict_patch_modes(tmp, dev, patch_npy, tiny=False):
    """(g) The predict CLI with (d)'s patch in each --patch_mode on phase
    4's first frame: no port kernel; the card's composite on the ingested
    frame equals the CPU's bit for bit, and the saved input is the CPU
    composite's pixels."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli.predict_and_save import (
        composite, main as predict_main)
    from eval_driving_safety_tpu_torch.config import PLACEMENT_BANDS
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, srcnn_clean01_device)
    from eval_driving_safety_tpu_torch.data.kitti import (load_image_u8,
                                                          srcnn_to_rgb01)
    from eval_driving_safety_tpu_torch.ops import _cuda
    cfg = srcnn_cfg(tiny)
    data = os.path.join(tmp, "kitti")
    b = prepare_srcnn_batch_u8([KittiStereoDataset(data).get(0)], cfg.input)
    means = np.asarray(cfg.input.pixel_means_bgr, np.float32)

    def ingest(device):
        put = lambda a: torch.as_tensor(a).to(device)
        w = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w", "wmask",
                                    "c")}
        return [srcnn_clean01_device(w, put(b[k])) * 255.0 - put(means)
                for k in ("im_left_u8", "im_right_u8")]
    rec = {}
    for mode in PLACEMENT_BANDS:
        _cuda.reset_launches()
        inp = os.path.join(tmp, f"srcnn_patch_in_{mode}")
        run_cli(["--data_path", data, "--detector", "srcnn", "--device",
                 str(dev), "--debug", "--debugnum", "1", "--patch_npy",
                 patch_npy, "--patch_mode", mode, "--save_input_dir", inp,
                 "--result_dir", os.path.join(tmp, f"srcnn_patch_res_{mode}")]
                + (["--tiny"] if tiny else []), predict_main)
        check(not any(_cuda.launches.values()),
              f"srcnn --patch_mode {mode}: launches {dict(_cuda.launches)}")
        with torch.inference_mode():
            card = composite(patch_npy, mode, 0, *ingest(dev))
            cpu = composite(patch_npy, mode, 0, *ingest("cpu"))
            clean = ingest("cpu")
        for k, sub in enumerate(("image_2", "image_3")):
            check(torch.equal(card[k].cpu(), cpu[k]),
                  f"srcnn --patch_mode {mode} {sub}: card composite != cpu")
            saved = load_image_u8(os.path.join(inp, sub, "000001.png"))
            want = np.clip(srcnn_to_rgb01(cpu[k][0].numpy(), means) * 255.0,
                           0, 255).astype(np.uint8)
            check(np.array_equal(saved, want), f"srcnn --patch_mode {mode} "
                  f"{sub}: saved input != cpu composite")
        cols = np.nonzero((cpu[1][0] != clean[1][0]).any(-1).any(0)
                          .numpy())[0]
        rec[mode] = [int(cols.min()), int(cols.max())] if cols.size else []
    log(json.dumps({"srcnn_predict_patch_modes": {
        "right_view_columns": rec}}))


def srcnn_fp32_predict(tmp, dev, tiny=False):
    """(h) The srcnn predict CLI once with --fp32 (1 frame): TF32 turned
    off by the CLI, its txt written, no port kernel launched."""
    import torch
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _cuda.reset_launches()
    res = os.path.join(tmp, "srcnn_pred_fp32")
    t, _, _ = run_cli(["--data_path", os.path.join(tmp, "kitti"),
                       "--detector", "srcnn", "--fp32", "--debug",
                       "--debugnum", "1", "--device", str(dev), "--ckpt",
                       os.path.join(tmp, "srcnn_planted.pt"),
                       "--result_dir", res] + (["--tiny"] if tiny else []),
                      predict_main)
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "the --fp32 srcnn predict CLI left TF32 on")
    check(not any(_cuda.launches.values()),
          f"the --fp32 srcnn predict CLI launched {dict(_cuda.launches)}")
    predict_layout_ok(res, SRCNN_IDS[:1], srcnn_cfg(tiny, "float32"))
    with open(os.path.join(res, "data", SRCNN_IDS[0] + ".txt")) as f:
        n = len(f.read().splitlines())
    log(json.dumps({"srcnn_fp32_predict": {"run_s": t, "detections": n}}))


def srcnn_predict_patch_phase(tmp, dev, card, tiny=False):
    """Phase 9 over phase 4's and phase 8's frames in `tmp`: the launches
    of its predict CLI runs and their pairs, and those of its patch CLI
    run and its steps."""
    import torch
    p_launches, pairs = srcnn_predict_cli(tmp, dev, tiny)
    srcnn_decode_card_vs_cpu(tmp, dev, tiny)
    torch.cuda.empty_cache()
    srcnn_predict_steady_state(tmp, dev, card, tiny)
    torch.cuda.empty_cache()
    patch_launches, steps, patch_npy = srcnn_patch_cli(tmp, dev, tiny)
    tiny_srcnn_patch_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    srcnn_patch_steady_state(tmp, dev, card, tiny)
    torch.cuda.empty_cache()
    srcnn_predict_patch_modes(tmp, dev, patch_npy, tiny)
    srcnn_fp32_predict(tmp, dev, tiny)
    torch.cuda.empty_cache()
    return p_launches, pairs, patch_launches, steps


# --------------------------------------------------------------- phase 10

CLS_TASKS = ("road_type", "dynamic_vehicle")
CLS_EPOCHS, CLS_BATCH, CLS_CROPS = 5, 32, 64


@contextlib.contextmanager
def classifier_size(size=None):
    """The classifier CLIs at `size` px instead of the published 224 (a
    rehearsal on the CPU runs at 64); None leaves them as they are."""
    from eval_driving_safety_tpu_torch.cli import train_classifier as TC
    from eval_driving_safety_tpu_torch.config import replace
    orig = TC.RoadTypeConfig, TC.DynamicVehicleConfig
    if size is not None:
        TC.RoadTypeConfig = lambda: replace(orig[0](), image_size=size)
        TC.DynamicVehicleConfig = lambda: replace(orig[1](), image_size=size)
    try:
        yield
    finally:
        TC.RoadTypeConfig, TC.DynamicVehicleConfig = orig


def write_crops(root, n=CLS_CROPS):
    """`n` seeded 224 x 224 crops named `<id>_<line>_<d|s>.png` (half
    moving), and their CSVs: train.csv lists all, val.csv the first
    half."""
    import numpy as np
    from eval_driving_safety_tpu_torch.data.kitti import write_png
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(2)
    rows = []
    for i in range(n):
        coarse = rng.randint(0, 256, (16, 16, 3))
        img = np.repeat(np.repeat(coarse, 14, 0), 14, 1)
        img = np.clip(img + rng.randint(-12, 13, img.shape), 0, 255)
        name = f"{i:06d}_{i % 5}_{'d' if i % 2 else 's'}.png"
        write_png(os.path.join(root, name), img.astype(np.uint8))
        rows.append(f"{name},{i % 2}\n")
    for csv, part in (("train.csv", rows), ("val.csv", rows[: n // 2])):
        with open(os.path.join(root, csv), "w") as f:
            f.write("".join(part))


def classifier_crops(tmp, dev):
    """(a) crop_images over phase 4's frames and labels (2 Cars a frame,
    no annotations: static crops), then the seeded crop set."""
    from eval_driving_safety_tpu_torch.cli.crop_images import \
        main as crop_main
    from eval_driving_safety_tpu_torch.data.kitti import load_image_u8
    data, out = os.path.join(tmp, "kitti"), os.path.join(tmp, "cls_kitti")
    csv = os.path.join(tmp, "cls_kitti.csv")
    t, _, log_out = run_cli(["--image_dir", os.path.join(data, "image_2"),
                             "--label_dir", os.path.join(data, "label_2"),
                             "--out_dir", out, "--csv", csv, "--device",
                             str(dev)], crop_main)
    names = sorted(os.listdir(out))
    want = [f"{fid}_{i}_s.png" for fid in SRCNN_IDS for i in range(2)]
    check(names == want, f"crop_images wrote {names}")
    with open(csv) as f:
        check(f.read() == "".join(f"{n},0\n" for n in want),
              "crop_images CSV")
    for n in names:
        img = load_image_u8(os.path.join(out, n))
        check(img.shape == (224, 224, 3) and img.std() > 0, f"crop {n}")
    write_crops(os.path.join(tmp, "cls_crops"))
    return {"crop_images_s": t, "kitti_crops": len(names)}


def classifier_train_validate(tmp, dev, size=None):
    """(b) train_classifier for each task at batch 32, 5 epochs (the
    first `ckpt_every`), on the seeded crops: finite losses, validation
    every 2 epochs, an epoch5/ checkpoint whose backbone equals its seeded
    init bit for bit and whose head moved; (c) validate_classifier on each
    checkpoint. No port kernel."""
    import torch
    from eval_driving_safety_tpu_torch.cli import train_classifier as TC
    from eval_driving_safety_tpu_torch.cli.validate_classifier import \
        main as validate_main
    from eval_driving_safety_tpu_torch.models.classifiers import \
        make_classifier
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        restore_checkpoint
    crops = os.path.join(tmp, "cls_crops")
    rec = {}
    _cuda.reset_launches()
    with classifier_size(size):
        for task in CLS_TASKS:
            ck = os.path.join(tmp, "cls_" + task)
            t, _, out = run_cli([
                "--task", task, "--image_dir", crops, "--train_csv",
                os.path.join(crops, "train.csv"), "--val_csv",
                os.path.join(crops, "val.csv"), "--epochs", str(CLS_EPOCHS),
                "--batch", str(CLS_BATCH), "--ckpt_dir", ck, "--device",
                str(dev)], TC.main)
            losses = [float(v) for v in re.findall(
                rf"epoch \d+/{CLS_EPOCHS}: loss (\S+)", out)]
            check(len(losses) == CLS_EPOCHS
                  and all(map(math.isfinite, losses)),
                  f"{task} training losses {losses}")
            val = [float(v) for v in re.findall(r"val accuracy: (\S+)", out)]
            check(len(val) == CLS_EPOCHS // 2, f"{task} validations {val}")
            path = os.path.join(ck, f"epoch{CLS_EPOCHS}")
            check(os.listdir(ck) == [f"epoch{CLS_EPOCHS}"],
                  f"{task} checkpoints {os.listdir(ck)}")
            saved = restore_checkpoint(path)
            check(saved["epoch"] == CLS_EPOCHS
                  and saved["opt_state"]["count"] == CLS_EPOCHS * (
                      CLS_CROPS // CLS_BATCH), f"{task} checkpoint")
            cfg = TC.task_config(task)
            model = make_classifier(task, cfg)
            init = model.init_weights(0).state_dict()
            for k, v in init.items():
                same = torch.equal(saved["params"][k], v)
                check(same != (k.split(".")[0] in model.head_names),
                      f"{task} {k}: the backbone changed or the head did "
                      "not")
            del model, init, saved
            tv, _, vout = run_cli([
                "--task", task, "--image_dir", crops, "--val_csv",
                os.path.join(crops, "val.csv"), "--ckpt", path, "--device",
                str(dev)], validate_main)
            m = re.search(r"accuracy: (\S+) \((\d+)/(\d+)\)", vout)
            check(m and int(m.group(3)) == CLS_CROPS // 2
                  and vout.count("  class ") == 2, f"{task} validate {vout}")
            rec[task] = {"train_s": t, "epoch_losses": losses,
                         "val_accuracy": val, "validate_s": tv,
                         "validate_accuracy": float(m.group(1))}
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"the classifier CLIs launched port kernels: {launches}")
    return rec, launches


def planted_classifiers(tmp, size=None):
    """Checkpoint directories of both classifiers (seeded, on the CPU)
    with the last layer planted over phase 4's frames: its kernel scaled
    so that the logits span 8, its bias in the middle of their widest gap,
    so every score lies far from 0.5 and both outcomes occur. Returns
    {task: path}, the frames and their labels."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli import train_classifier as TC
    from eval_driving_safety_tpu_torch.cli.classify_split import \
        frame_scores
    from eval_driving_safety_tpu_torch.data.kitti import (load_image_u8,
                                                          read_label)
    from eval_driving_safety_tpu_torch.models.classifiers import (
        make_classifier, make_eval_step)
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        save_checkpoint
    data = os.path.join(tmp, "kitti")
    frames = [torch.from_numpy(load_image_u8(os.path.join(
        data, "image_2", fid + ".png"))).float() / 255 for fid in SRCNN_IDS]
    objs = [read_label(os.path.join(data, "label_2", fid + ".txt"))
            for fid in SRCNN_IDS]
    paths = {}
    with classifier_size(size):
        for seed, task in enumerate(CLS_TASKS, start=1):
            cfg = TC.task_config(task)
            model = make_classifier(task, cfg).init_weights(seed).eval()
            step = (make_eval_step(model), cfg)
            probs = []
            for img, o in zip(frames, objs):
                road, dyn = frame_scores(
                    img, o, step if task == "road_type" else None,
                    step if task == "dynamic_vehicle" else None)
                probs += [road] if task == "road_type" else dyn
            p = np.asarray(probs, np.float64)
            logits = np.log(p / (1 - p))
            scale = 8.0 / (logits.max() - logits.min())
            logits = np.sort(logits * scale)
            i = int(np.argmax(np.diff(logits)))
            last = model.head if task == "road_type" else model.fc2
            with torch.no_grad():
                last.weight.mul_(scale)
                last.bias.sub_((logits[i] + logits[i + 1]) / 2)
            paths[task] = os.path.join(tmp, "cls_planted", task)
            save_checkpoint(paths[task], {"params": model.state_dict()})
    return paths, frames, objs


def classify_split_card_vs_cpu(tmp, dev, size=None):
    """(d) classify_split over phase 4's frames with the planted
    checkpoints, on the card and on the CPU: the same files byte for
    byte, both buckets and both codes, every score within 1e-4; no port
    kernel. Returns the planted paths and the card run's time."""
    from eval_driving_safety_tpu_torch.cli.classify_split import (
        frame_scores, main as classify_main)
    from eval_driving_safety_tpu_torch.cli.common import load_classifier
    from eval_driving_safety_tpu_torch.cli.train_classifier import \
        task_config
    from eval_driving_safety_tpu_torch.models.classifiers import \
        make_eval_step
    from eval_driving_safety_tpu_torch.ops import _cuda
    paths, frames, objs = planted_classifiers(tmp, size)
    runs = {}
    _cuda.reset_launches()
    with classifier_size(size):
        for name, d in (("card", dev), ("cpu", "cpu")):
            out_dir = os.path.join(tmp, f"cls_split_{name}")
            t, _, out = run_cli(["--data_path", os.path.join(tmp, "kitti"),
                                 "--road_ckpt", paths["road_type"],
                                 "--dyn_ckpt", paths["dynamic_vehicle"],
                                 "--out_dir", out_dir, "--device", str(d)],
                                classify_main)
            runs[name] = {"run_s": t, "files": png_dir_bytes(out_dir)}
        card, cpu = runs["card"]["files"], runs["cpu"]["files"]
        check(card == cpu, "classify_split: the card's folders differ from "
              "the CPU's")
        codes = "".join(v.decode() for k, v in card.items()
                        if "annotation" in k)
        check({k.split(os.sep)[0] for k in card} == {
            "road_dynamic_label", "road_dynamic_annotation",
            "dynamic_label", "dynamic_annotation"} and set(codes) >= {
            "0", "1"}, f"classify_split outcomes {sorted(card)} {codes!r}")
        steps = {}
        for d in (dev, "cpu"):
            steps[str(d)] = [
                (make_eval_step(load_classifier(t, task_config(t), paths[t],
                                                d)), task_config(t))
                for t in CLS_TASKS]
        err = 0.0
        for img, o in zip(frames, objs):
            got = [frame_scores(img.to(dev), o, *steps[str(dev)])]
            want = [frame_scores(img, o, *steps["cpu"])]
            for (r1, d1), (r2, d2) in zip(got, want):
                err = max(err, abs(r1 - r2), *(abs(a - b)
                                               for a, b in zip(d1, d2)))
        check(err <= 1e-4, f"classify_split scores card vs cpu: {err:.3g}")
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"classify_split launched port kernels: {launches}")
    return paths, {"card_run_s": runs["card"]["run_s"],
                   "cpu_run_s": runs["cpu"]["run_s"],
                   "max_score_err": err, "files": len(card)}


def classifier_step_card_vs_cpu(dev, size=None):
    """(e) One fp32 train step of each classifier (TF32 off) on the card
    and on the CPU: the same seeded weights, 8 seeded inputs and the same
    dropout mask; the loss within 1e-4 relative, the head's gradients
    within 1e-3 of their largest, no port kernel."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli import train_classifier as TC
    from eval_driving_safety_tpu_torch.models.classifiers import (
        make_classifier, make_train_state, make_train_step)
    rec = {}
    with classifier_size(size):
        for task in CLS_TASKS:
            cfg = TC.task_config(task)
            sd = make_classifier(task, cfg).init_weights(2).state_dict()
            rng = np.random.RandomState(3)
            s = cfg.image_size
            x = torch.from_numpy(rng.randn(8, s, s, 3).astype(np.float32))
            y = torch.from_numpy((rng.rand(8) > 0.5).astype(np.float32))
            width = 2048 if task == "road_type" else 4096
            mask = torch.from_numpy(rng.rand(8, width) > cfg.dropout)

            def run(device, task=task, cfg=cfg, sd=sd, x=x, y=y, mask=mask):
                model = make_classifier(task, cfg)
                model.load_state_dict(sd)
                model.to(device)
                opt = make_train_state(model, lambda n: cfg.lr)
                loss = make_train_step(model, opt)(
                    x.to(device), y.to(device), dropout_mask=mask)
                return float(loss), [p.grad.cpu()
                                     for p in model.head_parameters()]
            card_vs_cpu(f"classifier_step_card_vs_cpu_{task}", run, {}, dev)
            rec[task] = True
    return rec


def classifier_steady_state(tmp, dev, card, paths, size=None):
    """(f) Steady state, fp32: each task's train step at batch 32 (inputs
    on the card: the step alone) and classify_split's frame (the road
    score of the full frame, its two crops scored as one batch, as the CLI
    runs it on a decoded frame on the card): steps and frames per
    second, peak memory, a profile of one (kernel time, busy share, top
    kernels)."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.cli import train_classifier as TC
    from eval_driving_safety_tpu_torch.cli.classify_split import \
        frame_scores
    from eval_driving_safety_tpu_torch.cli.common import load_classifier
    from eval_driving_safety_tpu_torch.models.classifiers import (
        make_classifier, make_eval_step, make_train_state, make_train_step)
    rec = {}

    def measure(fn, n):
        fn()
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / n
        peak = torch.cuda.max_memory_allocated()
        rows, total_us, port_us = profile_kernels(fn)
        check(port_us == 0, "a classifier path ran a port kernel")
        return {"ms": per * 1e3, "per_s": 1.0 / per,
                "peak_device_mem_gib": peak / 2 ** 30,
                "profiled_kernel_ms": total_us / 1e3,
                "kernel_launches": sum(c for _, _, c in rows),
                "device_busy_share": (total_us / 1e3) / (per * 1e3),
                "top_kernels_ms": [[k[:90], c, us / 1e3]
                                   for us, k, c in rows[:8]]}

    with classifier_size(size):
        for task in CLS_TASKS:
            cfg = TC.task_config(task)
            model = make_classifier(task, cfg).init_weights(0).to(dev)
            step = make_train_step(model, make_train_state(
                model, lambda n: cfg.lr))
            rng = np.random.RandomState(4)
            s = cfg.image_size
            x = torch.from_numpy(rng.randn(CLS_BATCH, s, s, 3).astype(
                np.float32)).to(dev)
            y = torch.from_numpy((rng.rand(CLS_BATCH) > 0.5).astype(
                np.float32)).to(dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            r = measure(lambda: step(x, y, generator=gen), 5)
            rec[f"{task}_train_step"] = {"batch": CLS_BATCH, **r}
            del model, step, x
            torch.cuda.empty_cache()
        steps = [(make_eval_step(load_classifier(t, TC.task_config(t),
                                                 paths[t], dev)),
                  TC.task_config(t)) for t in CLS_TASKS]
        from eval_driving_safety_tpu_torch.data.kitti import (load_image_u8,
                                                              read_label)
        data = os.path.join(tmp, "kitti")
        img = torch.from_numpy(load_image_u8(os.path.join(
            data, "image_2", SRCNN_IDS[0] + ".png"))).to(dev).float() / 255
        objs = read_label(os.path.join(data, "label_2",
                                       SRCNN_IDS[0] + ".txt"))
        rec["classify_split_frame"] = {"vehicles": len(objs), **measure(
            lambda: frame_scores(img, objs, *steps), 10)}
    log(json.dumps({"classifier_steady_state": {
        "image_size": size or 224, "dtype": "float32, TF32 off", **rec,
        "card": card}}))
    return rec


def classifier_phase(tmp, dev, card, size=None):
    """Phase 10 over phase 4's frames in `tmp`; the launches of its CLI
    runs and their train steps."""
    import torch
    rec = classifier_crops(tmp, dev)
    train, launches = classifier_train_validate(tmp, dev, size)
    torch.cuda.empty_cache()
    paths, split = classify_split_card_vs_cpu(tmp, dev, size)
    classifier_step_card_vs_cpu(dev, size)
    torch.cuda.empty_cache()
    classifier_steady_state(tmp, dev, card, paths, size)
    torch.cuda.empty_cache()
    log(json.dumps({"classifier_clis": {
        "image_size": size or 224, "batch": CLS_BATCH,
        "epochs": CLS_EPOCHS, "crops": CLS_CROPS, **rec, **train,
        "classify_split": split, "launches": launches}}))
    return launches, len(CLS_TASKS) * CLS_EPOCHS * (CLS_CROPS // CLS_BATCH)


# --------------------------------------------------------------- phase 11

SRCNN_TRAIN_SAMPLED = (
    "backbone.stem_conv.weight", "backbone.layer2_block0.Conv_1.weight",
    "fpn.smooth1.bias", "rpn.rpn_cls.bias", "rpn.rpn_box.weight",
    "rcnn.fc1.weight", "rcnn.cls_score.bias", "rcnn.bbox_pred.weight",
    "rcnn.dim_orien_pred.bias", "kpts.kpts_deconv.weight",
    "kpts.kpts_class.weight")


def srcnn_train_cli(tmp, dev, tiny=False):
    """(a) train_detector --detector srcnn at StereoRCNNConfig() fp32 over
    phase 4's two frames: 2 epochs with a checkpoint each, then a resumed
    third; finite losses, an `uncert` that moves, FrozenBatchNorm
    statistics bit for bit at their seeded init, no port kernel; then the
    srcnn attack and predict CLIs on the last checkpoint. Returns the
    launches and the training steps."""
    import torch
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.cli.train_detector import \
        main as train_main
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        restore_checkpoint
    ck = os.path.join(tmp, "srcnn_ckpts")
    common = ["--data_path", os.path.join(tmp, "kitti"), "--detector",
              "srcnn", "--device", str(dev), "--ckpt_every", "1",
              "--ckpt_dir", ck] + (["--tiny"] if tiny else [])
    _cuda.reset_launches()
    t1, _, out1 = run_cli(common + ["--epochs", "2"], train_main)
    t2, _, out2 = run_cli(common + ["--epochs", "1", "--resume"], train_main)
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"Stereo R-CNN training launched port kernels: {launches}")
    check(f"resumed from {os.path.join(ck, 'epoch2')} (epoch 2)" in out2,
          "srcnn training did not resume")
    epochs = re.findall(r"epoch (\d+): loss (\S+) uncert (\[[^\]]*\])",
                        out1 + out2)
    check([int(e) for e, _, _ in epochs] == [1, 2, 3]
          and all(math.isfinite(float(v)) for _, v, _ in epochs),
          f"srcnn training epochs {epochs}")
    check(sorted(os.listdir(ck)) == ["epoch1", "epoch2", "epoch3"],
          f"srcnn checkpoints {os.listdir(ck)}")
    cks = [restore_checkpoint(os.path.join(ck, f"epoch{e}"))
           for e in (1, 2, 3)]
    steps = 3 * len(SRCNN_IDS)
    check(cks[2]["opt_state"]["count"] == steps, "srcnn optimizer count")
    check(all(c["uncert"].abs().min() > 0 for c in cks)
          and not torch.equal(cks[0]["uncert"], cks[2]["uncert"]),
          f"uncert did not move: {[c['uncert'].tolist() for c in cks]}")
    init = StereoRCNN(srcnn_cfg(tiny, "float32")).init_weights(0)
    stats = 0
    for k, v in init.state_dict().items():
        if k.endswith((".mean", ".var")):
            stats += 1
            check(all(torch.equal(c["params"][k], v) for c in cks),
                  f"srcnn training wrote the statistic {k}")
    w = "rcnn.cls_score.weight"
    check(not torch.equal(cks[2]["params"][w], init.state_dict()[w]),
          "srcnn training did not move the weights")
    uncerts = [c["uncert"].tolist() for c in cks]
    del cks, init
    last = os.path.join(ck, "epoch3")
    ta, losses, out = run_cli([
        "--data_path", os.path.join(tmp, "kitti"), "--detector", "srcnn",
        "--iter", "1", "--debug", "--debugnum", "1", "--device", str(dev),
        "--ckpt", last, "--out_prefix",
        os.path.join(tmp, "srcnn_trained_adv", "p")]
        + (["--tiny"] if tiny else []))
    check(f"loaded Stereo R-CNN weights from {last}, uncert" in out
          and len(losses) == 1 and all(map(math.isfinite, losses[0])),
          f"the srcnn attack on the trained checkpoint: {out[-300:]}")
    res = os.path.join(tmp, "srcnn_trained_pred")
    tp, _, out = run_cli([
        "--data_path", os.path.join(tmp, "kitti"), "--detector", "srcnn",
        "--debug", "--debugnum", "1", "--device", str(dev), "--ckpt", last,
        "--result_dir", res] + (["--tiny"] if tiny else []), predict_main)
    predict_layout_ok(res, SRCNN_IDS[:1], srcnn_cfg(tiny))
    log(json.dumps({"srcnn_train_cli": {
        "config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} float32",
        "frames": len(SRCNN_IDS), "epochs": 3, "steps": steps,
        "run_s": t1, "resume_run_s": t2,
        "epoch_losses": [float(v) for _, v, _ in epochs],
        "checkpoint_uncert": uncerts,
        "frozen_statistics_checked": stats, "attack_s": ta,
        "predict_s": tp, "launches": launches}}))
    return launches, steps


def tiny_srcnn_train_card_vs_cpu(tmp, dev):
    """(b) One training step of the tiny Stereo R-CNN in fp32 (TF32 off)
    on the card and on the CPU: the same weights, u8 frame, gt and draws;
    the total loss within 1e-4 relative and sampled parameters' clipped
    gradients within 1e-3 of their largest, no port kernel."""
    import torch
    from eval_driving_safety_tpu_torch.cli.train_detector import (
        make_detector_optimizer, make_srcnn_train_step, warmup_cosine_decay)
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, make_gt_batch)
    cfg = srcnn_cfg(True, "float32")
    sd = StereoRCNN(cfg).init_weights(3).state_dict()
    b = prepare_srcnn_batch_u8([KittiStereoDataset(os.path.join(
        tmp, "kitti")).get(0)], cfg.input)
    gt = make_gt_batch(b["objects"], b["calibs"], cfg,
                       image_scale=b["scales"])
    model0 = StereoRCNN(cfg)
    draws = model0.sample_draws(1, torch.Generator().manual_seed(7))

    def run(device):
        model = StereoRCNN(cfg)
        model.load_state_dict(sd)
        model.to(device)
        uncert = torch.nn.Parameter(torch.zeros(6, device=device))
        opt = make_detector_optimizer(
            [*model.named_parameters(), ("uncert", uncert)],
            warmup_cosine_decay(1e-3, 1, 10))
        step = make_srcnn_train_step(model, uncert, opt, cfg, device)
        put = lambda a: torch.as_tensor(a).to(device)
        total, _ = step(put(b["im_left_u8"]), put(b["im_right_u8"]),
                        {k: put(b[k]) for k in ("ih", "iw", "den_h",
                                                "den_w", "wmask", "c")},
                        {k: v.to(device) for k, v in gt.items()},
                        type(draws)(*(d.to(device) for d in draws)))
        params = dict(model.named_parameters())
        return float(total), [params[k].grad.cpu()
                              for k in SRCNN_TRAIN_SAMPLED] + [
                                  uncert.grad.cpu()]
    card_vs_cpu("tiny_srcnn_train_card_vs_cpu", run, {}, dev)


def srcnn_train_steady_state(tmp, dev, card, tiny=False):
    """(c) The steady-state Stereo R-CNN training step at
    StereoRCNNConfig() fp32 (TF32 off) on phase 4's first frame, as the
    CLI runs it (u8 ingest, fresh draws, the joint step over the network
    and `uncert`): steps per second, peak memory and a profile of one
    step (kernel time, busy share, top kernels)."""
    import torch
    from eval_driving_safety_tpu_torch.cli.common import use_srcnn_precision
    from eval_driving_safety_tpu_torch.cli.train_detector import (
        make_detector_optimizer, make_srcnn_train_step, warmup_cosine_decay)
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, make_gt_batch)
    cfg = srcnn_cfg(tiny, "float32")
    use_srcnn_precision(cfg)
    model = StereoRCNN(cfg).init_weights(0).to(dev)
    uncert = torch.nn.Parameter(torch.zeros(6, device=dev))
    opt = make_detector_optimizer(
        [*model.named_parameters(), ("uncert", uncert)],
        warmup_cosine_decay(1e-3, 200, 10000))
    step = make_srcnn_train_step(model, uncert, opt, cfg, dev)
    b = prepare_srcnn_batch_u8([KittiStereoDataset(os.path.join(
        tmp, "kitti")).get(0)], cfg.input)
    gt = make_gt_batch(b["objects"], b["calibs"], cfg,
                       image_scale=b["scales"], device=dev)
    put = lambda a: torch.as_tensor(a).to(dev)
    il, ir = put(b["im_left_u8"]), put(b["im_right_u8"])
    w = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w", "wmask", "c")}
    gen = torch.Generator(device=dev).manual_seed(1)
    totals = []

    def one():
        totals.append(step(il, ir, w, gt, model.sample_draws(1, gen))[0])

    n = 3
    one()
    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        one()
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()
    rows, total_us, port_us = profile_kernels(one)
    check(all(math.isfinite(float(t)) for t in totals),
          "srcnn training steady-state losses")
    check(port_us == 0, "the srcnn training step ran a port kernel")
    rec = {"config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} float32, "
                     "TF32 off", "batch": 1, "step_ms": per * 1e3,
           "steps_per_s": 1.0 / per, "peak_device_mem_gib": peak / 2 ** 30,
           "profiled_kernel_ms": total_us / 1e3,
           "kernel_launches_per_step": sum(c for _, _, c in rows),
           "device_busy_share": (total_us / 1e3) / (per * 1e3),
           "top_kernels_ms": [[k[:90], c, us / 1e3]
                              for us, k, c in rows[:16]],
           "card": card}
    log(json.dumps({"srcnn_train_step": rec}))
    return rec


def upstream_srcnn_state_dict(cfg, seed=0):
    """A seeded random Stereo R-CNN state dict at `cfg`'s widths in the
    upstream published layout: RCNN_layer{0..4} (torch BatchNorm weight,
    bias, running statistics and num_batches_tracked), the RCNN_toplayer /
    latlayer / smooth FPN, RCNN_rpn with class-major scores, RCNN_top's
    two full-extent convs, the Linear heads, RCNN_kpts' convs at even
    indices (ReLUs between) and its 2x2 transposed conv, and kpts_class.
    Kernels are scaled by 1/sqrt(fan in), so activations stay finite."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    def conv(name, cout, cin, k, bias=True):
        sd[f"{name}.weight"] = rand(cout, cin, k, k) / math.sqrt(cin * k * k)
        if bias:
            sd[f"{name}.bias"] = 0.01 * rand(cout)

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.rand(c, generator=g)
        sd[f"{name}.bias"] = 0.01 * rand(c)
        sd[f"{name}.running_mean"] = 0.01 * rand(c)
        sd[f"{name}.running_var"] = 1.0 + 0.1 * torch.rand(c, generator=g)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    wid = cfg.backbone_width
    conv("RCNN_layer0.0", wid, 3, 7, bias=False)
    bn("RCNN_layer0.1", wid)
    cin = wid
    for stage, blocks in enumerate(cfg.backbone_blocks, start=1):
        width = wid * 2 ** (stage - 1)
        for blk in range(blocks):
            pre = f"RCNN_layer{stage}.{blk}."
            for i, (co, ci, k) in enumerate(((width, cin, 1),
                                             (width, width, 3),
                                             (4 * width, width, 1)), 1):
                conv(f"{pre}conv{i}", co, ci, k, bias=False)
                bn(f"{pre}bn{i}", co)
            if blk == 0:
                conv(pre + "downsample.0", 4 * width, cin, 1, bias=False)
                bn(pre + "downsample.1", 4 * width)
            cin = 4 * width
    ch, c5 = cfg.fpn_channels, 32 * wid
    for name, ci, k in (("toplayer", c5, 1), ("latlayer1", c5 // 2, 1),
                        ("latlayer2", c5 // 4, 1), ("latlayer3", c5 // 8, 1),
                        ("smooth1", ch, 3), ("smooth2", ch, 3),
                        ("smooth3", ch, 3)):
        conv("RCNN_" + name, ch, ci, k)
    a = len(cfg.anchor_ratios)
    conv("RCNN_rpn.RPN_Conv", 512, ch, 3)
    conv("RCNN_rpn.RPN_cls_score", 2 * a, 1024, 1)
    conv("RCNN_rpn.RPN_bbox_pred_left_right", 6 * a, 1024, 1)
    conv("RCNN_top.0", 1024, 2 * ch, cfg.pooling_size)
    conv("RCNN_top.2", 1024, 1024, 1)
    for name, o in (("RCNN_cls_score", cfg.num_classes),
                    ("RCNN_bbox_pred", 6 * cfg.num_classes),
                    ("RCNN_dim_orien_pred", 5 * cfg.num_classes)):
        sd[f"{name}.weight"] = rand(o, 1024) / 32.0
        sd[f"{name}.bias"] = 0.01 * rand(o)
    for i in range(cfg.kpts_convs):
        conv(f"RCNN_kpts.{2 * i}", 256, ch if i == 0 else 256, 3)
    n = 2 * cfg.kpts_convs
    sd[f"RCNN_kpts.{n}.weight"] = rand(256, 256, 2, 2) / 32.0
    sd[f"RCNN_kpts.{n}.bias"] = 0.01 * rand(256)
    conv("kpts_class", 6, 256, 1)
    return sd


def published_srcnn_clis(tmp, dev, tiny=False):
    """(d) A random Stereo R-CNN state dict in the upstream published
    layout (`{"model": {"module.<key>": tensor}, "uncert": (6,)}`),
    written without JAX, read by the srcnn attack, predict and patch CLIs
    with 0 unmapped keys; the imported weights equal the file's (the RPN's
    scores reordered anchor-major, RCNN_top's first conv as a Dense over
    the NHWC flatten, the transposed conv as it is). No port kernel."""
    import torch
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        main as patch_main
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.utils.torch_import import \
        load_stereo_rcnn_checkpoint
    cfg = srcnn_cfg(tiny, "float32")
    sd = upstream_srcnn_state_dict(cfg, seed=5)
    uncert = torch.tensor([-1.0, -0.8, 0.1, 0.2, -0.3, 0.4])
    path = os.path.join(tmp, "stereo_rcnn_published.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()},
                "uncert": uncert, "epoch": 12}, path)
    model, imported, got_uncert = load_stereo_rcnn_checkpoint(path, cfg)
    check(imported["unmapped"] == [] and torch.equal(got_uncert, uncert),
          f"published import: unmapped {imported['unmapped'][:8]}")
    mine = model.state_dict()
    a = len(cfg.anchor_ratios)
    perm = [k * a + i for i in range(a) for k in range(2)]
    w = sd["RCNN_top.0.weight"]
    check(torch.equal(mine["rpn.rpn_cls.bias"],
                      sd["RCNN_rpn.RPN_cls_score.bias"][perm])
          and torch.equal(mine["rcnn.fc1.weight"],
                          w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))
          and torch.equal(mine["kpts.kpts_deconv.weight"],
                          sd[f"RCNN_kpts.{2 * cfg.kpts_convs}.weight"]),
          "published import: weights not laid out as the file's")
    del model, mine
    base = ["--data_path", os.path.join(tmp, "kitti"), "--detector",
            "srcnn", "--debug", "--debugnum", "1", "--device", str(dev),
            "--ckpt", path] + (["--tiny"] if tiny else [])
    _cuda.reset_launches()
    runs = {}
    for name, main, extra in (
            ("attack", None, ["--iter", "1", "--out_prefix",
                              os.path.join(tmp, "srcnn_pub_adv", "p")]),
            ("predict", predict_main,
             ["--result_dir", os.path.join(tmp, "srcnn_pub_pred")]),
            ("patch", patch_main,
             ["--epochs", "1", "--iters", "1", "--save_dir",
              os.path.join(tmp, "srcnn_pub_patch")])):
        t, _, out = run_cli(base + extra, main)
        check("kpts convs=4, unmapped=0)" in out and "WARNING: " not in
              out.replace("WARNING: no --ckpt", ""),
              f"published .pth through the {name} CLI: {out[-300:]}")
        runs[name + "_s"] = t
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"the published-checkpoint CLIs launched {launches}")
    log(json.dumps({"published_srcnn_clis": {
        "config": f"{'tiny' if tiny else 'StereoRCNNConfig()'} widths",
        "keys": len(sd), "unmapped": 0, **runs, "launches": launches}}))


def srcnn_train_phase(tmp, dev, card, tiny=False):
    """Phase 11 over phase 4's frames in `tmp`; the launches of its
    training CLI runs and their steps."""
    import torch
    launches, steps = srcnn_train_cli(tmp, dev, tiny)
    torch.cuda.empty_cache()
    tiny_srcnn_train_card_vs_cpu(tmp, dev)
    srcnn_train_steady_state(tmp, dev, card, tiny)
    torch.cuda.empty_cache()
    published_srcnn_clis(tmp, dev, tiny)
    torch.cuda.empty_cache()
    return launches, steps


# --------------------------------------------------------------- phase 12

# the reference's kitti_labeled corpus: 319 static, 69 dynamic and 168
# road-dynamic frames (label folder, annotation folder, frames)
CORPUS = (("static_label", None, 319),
          ("dynamic_label", "dynamic_annotation", 69),
          ("road_dynamic_label", "road_dynamic_annotation", 168))
CORPUS_VEHICLES = ("Car",) * 8 + ("Van", "Truck", "Misc")
CORPUS_OTHERS = ("Pedestrian", "Cyclist", "DontCare")
# KITTI's mean (h, w, l) of each class
CORPUS_DIMS = {"Car": (1.53, 1.63, 3.88), "Van": (2.21, 1.90, 5.08),
               "Truck": (3.25, 2.59, 10.1), "Misc": (1.91, 1.51, 3.58),
               "Pedestrian": (1.76, 0.66, 0.84),
               "Cyclist": (1.74, 0.60, 1.76), "DontCare": (-1.0, -1.0, -1.0)}


def corpus_object(rng, typ, x, z, ry, score=None):
    """A KITTI label (a detection with a score) of an object of class `typ`
    at (x, z) in the camera frame, heading ry: its size within 10% of the
    class mean, its bottom 1.4-1.8 m below the camera, its 2D box
    projected through KITTI's camera."""
    import numpy as np
    from eval_driving_safety_tpu_torch.data.kitti import KittiObject
    h, w, l = (d * rng.uniform(0.9, 1.1) for d in CORPUS_DIMS[typ])
    y = 1.6 + rng.uniform(-0.2, 0.2)
    u, v = 609.6 + 721.5 * x / z, 172.9 + 721.5 * y / z
    bw, bh = 721.5 * w / z, 721.5 * h / z
    return KittiObject(
        typ, rng.uniform(0, 0.3), rng.randint(0, 3), -math.atan2(x, z) + ry,
        np.array([u - bw / 2, v - bh, u + bw / 2, v]), np.array([h, w, l]),
        np.array([x, y, z]), ry, score)


def corpus_frame(rng):
    """One frame's objects (class, x, z, ry): 0-12 vehicles, most in the
    side lanes (3-15 m off the camera's axis) and 2% in the ego lane, 4-45
    m ahead, 80% driving along the road either way; 0-3 pedestrians,
    cyclists or DontCare boxes among them."""
    objs = []
    for _ in range(rng.randint(0, 13)):
        typ = CORPUS_VEHICLES[rng.randint(len(CORPUS_VEHICLES))]
        x = rng.uniform(-1.5, 1.5) if rng.rand() < 0.02 else \
            rng.choice((-1, 1)) * rng.uniform(3.0, 15.0)
        z = rng.uniform(4.0, 45.0)
        ry = (rng.choice((-0.5, 0.5)) * math.pi + rng.normal(0, 0.15)
              if rng.rand() < 0.8 else rng.uniform(-math.pi, math.pi))
        objs.append((typ, x, z, (ry + math.pi) % (2 * math.pi) - math.pi))
    for _ in range(rng.randint(0, 4)):
        objs.insert(rng.randint(len(objs) + 1), (
            CORPUS_OTHERS[rng.randint(3)], rng.uniform(-15, 15),
            rng.uniform(4, 45), rng.uniform(-math.pi, math.pi)))
    return objs


def write_labeled_corpus(root, counts=CORPUS, seed=0):
    """A seeded `kitti_labeled/` tree under `root` in the reference's
    layout with `counts` frames a class, and `det/`, a detection txt a
    frame: each GT object missed with probability 0.1, else moved by
    N(0, 0.3 m) across and N(0, 3%) in depth and turned by N(0, 0.1 rad),
    with a score; 5% of the frames get a false car. Annotation codes: 'n'
    for the non-vehicles and 5% of the vehicles, '0' 55%, '1' 35% and
    '-1' 5%. Returns the frame ids."""
    import numpy as np
    from eval_driving_safety_tpu_torch.data.kitti import write_label
    rng = np.random.RandomState(seed)
    total = sum(n for _, _, n in counts)
    ids = [f"{i:06d}" for i in rng.choice(7481, total, replace=False)]
    det_dir = os.path.join(root, "det")
    os.makedirs(det_dir, exist_ok=True)
    k = 0
    for sub, anno_sub, n in counts:
        for d in (sub, anno_sub):
            if d:
                os.makedirs(os.path.join(root, "kitti_labeled", d),
                            exist_ok=True)
        for fid in ids[k:k + n]:
            gt, codes, det = [], [], []
            for typ, x, z, ry in corpus_frame(rng):
                gt.append(corpus_object(rng, typ, x, z, ry))
                codes.append(("0", "1", "-1", "n")[rng.choice(
                    4, p=(0.55, 0.35, 0.05, 0.05))]
                    if typ in CORPUS_VEHICLES else "n")
                if rng.rand() >= 0.1:
                    det.append(corpus_object(
                        rng, typ, x + rng.normal(0, 0.3),
                        z + rng.normal(0, 0.03 * z), ry + rng.normal(0, 0.1),
                        rng.uniform(0.05, 1.0)))
            if rng.rand() < 0.05:
                det.append(corpus_object(
                    rng, "Car", rng.uniform(-15, 15), rng.uniform(4, 45),
                    rng.uniform(-math.pi, math.pi), rng.uniform(0.05, 0.5)))
            write_label(os.path.join(root, "kitti_labeled", sub,
                                     fid + ".txt"), gt)
            write_label(os.path.join(det_dir, fid + ".txt"), det)
            if anno_sub:
                with open(os.path.join(root, "kitti_labeled", anno_sub,
                                       fid + ".txt"), "w") as f:
                    f.write("".join(c + "\n" for c in codes))
        k += n
    return ids


def plan_and_check(work, sc, gt, dyna):
    """plan_motion over the scenarios in `sc` into `work`/solutions, then
    check_collision --check_all against `gt` from `work` as the working
    directory. Returns (plan seconds, check seconds, plan records, the
    colliding ids, collision.txt's count)."""
    from eval_driving_safety_tpu_torch.cli import check_collision, plan_motion
    sol = os.path.join(work, "solutions")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        records = plan_motion.main(["--input_folder", sc, "--output_folder",
                                    sol, "--dyna_obj_folder", dyna])
    t_plan = time.perf_counter() - t0
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t_check, _, out = run_cli([
            "--check_all", "--scenario_path", gt, "--solution_path", sol],
            check_collision.main)
    finally:
        os.chdir(cwd)
    with open(os.path.join(work, "collision.txt")) as f:
        n_coll = int(f.read())
    solved = sorted(r["id"] for r in records if r["states"])
    check(sorted(n[17:23] for n in os.listdir(sol)) == solved
          if os.path.isdir(sol) else not solved,
          f"{work}: solutions {solved} not written")
    return t_plan, t_check, records, out.strip().splitlines()[:-1], n_coll


def safety_chain(work, labeled, det_dir, gt=None):
    """The safety CLIs over one folder of detection txts: convert_gt_
    scenarios of the `labeled` tree (unless `gt` holds its scenarios),
    convert_scenarios and plan_motion with --dyna_obj_folder `labeled`'s
    road_dynamic_label, check_collision --check_all from `work` as the
    working directory, eval --json. Checks that every file is written,
    that the rates lie in [0, 1] and that collision.txt counts
    num_collisions. Returns (seconds a stage, plan records, metrics, the
    colliding ids, gt)."""
    from eval_driving_safety_tpu_torch.cli import (
        convert_gt_scenarios, convert_scenarios, eval as eval_cli)
    os.makedirs(work, exist_ok=True)
    dyna = os.path.join(labeled, "road_dynamic_label")
    sc = os.path.join(work, "scenarios")
    secs = {}
    if gt is None:
        gt = os.path.join(work, "gt")
        secs["convert_gt"], _, _ = run_cli([
            "--input_folder", labeled, "--output_folder", gt],
            convert_gt_scenarios.main)
    secs["convert"], _, _ = run_cli([
        "--input_folder", det_dir, "--output_folder", sc,
        "--dyna_obj_folder", dyna], convert_scenarios.main)
    secs["plan"], secs["check"], records, colliding, n_coll = \
        plan_and_check(work, sc, gt, dyna)
    secs["eval"], _, out = run_cli([
        "--scenario_path", sc, "--solution_path", os.path.join(
            work, "solutions"), "--gt_scenario_path", gt, "--json"],
        eval_cli.main)
    metrics = json.loads(out.strip().splitlines()[-1])
    txts = sorted(n[:-4] for n in os.listdir(det_dir) if n.endswith(".txt"))
    check(sorted(n[:-4] for n in os.listdir(sc)) == txts,
          f"{work}: a scenario is missing")
    check(n_coll == metrics["num_collisions"] == len(colliding)
          and metrics["num_scenarios"] == len(txts)
          and metrics["num_solutions"] == sum(r["states"] > 0
                                              for r in records)
          and all(0.0 <= metrics[k] <= 1.0 for k in (
              "success_rate", "collision_rate", "safe_driving_rate")),
          f"{work}: collision.txt {n_coll}, metrics {metrics}")
    return secs, records, metrics, colliding, gt


def card_detections_chain(tmp):
    """(a) The earlier phases' outputs through the safety CLIs: phase 10's
    classify_split folders (phase 4's GT labels, bucketed and coded by the
    planted classifiers) to GT scenarios, then each detector's txts
    (phase 6's DSGN on the clean and the attacked frames, phase 9's
    Stereo R-CNN on both) to scenarios, solutions, collisions and
    metrics."""
    labeled = os.path.join(tmp, "cls_split_card")
    gt, rec = None, {}
    for name, det in (("dsgn_clean", "pred_steady"), ("dsgn_attacked",
                                                      "pred_a"),
                      ("srcnn_clean", "srcnn_pred_clean"),
                      ("srcnn_attacked", "srcnn_pred_attacked")):
        secs, records, metrics, _, gt = safety_chain(
            os.path.join(tmp, "safety_" + name), labeled,
            os.path.join(tmp, det, "data"), gt)
        rec[name] = {"seconds": secs, **metrics}
    return rec


def plots_of(run, colliding):
    """(d) plot_scenario and plot_solution on two of the corpus's
    scenarios (a colliding and a clean solution over the GT) and
    check_collision in single mode with --plot: each PNG decodes at the
    plots' 600 x 1000."""
    from eval_driving_safety_tpu_torch.cli import (check_collision,
                                                    plot_scenario,
                                                    plot_solution)
    from eval_driving_safety_tpu_torch.data.kitti import decode_png_rgb
    sol = os.path.join(run, "solutions")
    names = sorted(os.listdir(sol))
    hit = next(n for n in names if n[17:23] in colliding)
    clean = next(n for n in names if n[17:23] not in colliding)
    pngs = {}
    for tag, main, name in (("plot_scenario", plot_scenario.main, hit),
                            ("plot_solution", plot_solution.main, clean),
                            ("check_collision_plot", check_collision.main,
                             hit)):
        png = os.path.join(run, "plots", tag + ".png")
        args = ["--scenario_path", os.path.join(run, "gt",
                                                name[17:23] + ".xml"),
                "--solution_path", os.path.join(sol, name)]
        if main is check_collision.main:
            _, _, out = run_cli(args + ["--plot", png], main)
            check("Does collision exist?  True" in out,
                  f"single-mode check of {name}: {out}")
        else:
            run_cli(args + ["--output", png], main)
        with open(png, "rb") as f:
            img = decode_png_rgb(f.read())
        check(img.shape == (600, 1000, 3) and (img < 200).any(),
              f"{tag}: {img.shape}")
        pngs[tag] = name[17:23]
    return pngs


def safety_phase(tmp, card):
    """Phase 12 over the earlier phases' outputs in `tmp`: (a) the card's
    detections through the safety CLIs; (b) the corpus at the reference's
    size through them, with solved and unsolved scenarios and colliding
    and clean solutions; (d) plots of two of its scenarios; (c) a rerun of
    (b)'s chain that must write the same bytes and metrics; (e) no port
    kernel launched; (f) the `safety_pipeline` line."""
    import hashlib
    import shutil
    import numpy as np
    from eval_driving_safety_tpu_torch.config import PlannerConfig
    from eval_driving_safety_tpu_torch.ops import _cuda
    t_phase = time.perf_counter()
    before = dict(_cuda.launches)
    card_runs = card_detections_chain(tmp)
    root = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    ids = write_labeled_corpus(root)
    t_corpus = time.perf_counter() - t0
    labeled = os.path.join(root, "kitti_labeled")
    runs = []
    for k in range(2):
        run = os.path.join(root, f"run{k}")
        secs, records, metrics, colliding, _ = safety_chain(
            run, labeled, os.path.join(root, "det"))
        # every file the chain wrote (scenarios, solutions, collision.txt)
        digest = {name: hashlib.sha256(data).hexdigest()
                  for name, data in png_dir_bytes(run).items()}
        runs.append((secs, records, metrics, colliding, digest))
        if k == 0:
            n_sol = metrics["num_solutions"]
            check(metrics["num_scenarios"] == len(ids) == 556
                  and 0 < n_sol < 556
                  and 0 < metrics["num_collisions"] < n_sol,
                  f"the corpus's outcomes {metrics}: no unsolved scenario "
                  "or no colliding or clean solution")
            t0 = time.perf_counter()
            pngs = plots_of(run, colliding)
            t_plots = time.perf_counter() - t0
        shutil.rmtree(run)
    check(all(a == b for a, b in zip(runs[0][2:], runs[1][2:]))
          and [r["expansions"] for r in runs[0][1]]
          == [r["expansions"] for r in runs[1][1]],
          "a rerun of the corpus's chain wrote other bytes or metrics")
    shutil.rmtree(root)
    after = dict(_cuda.launches)
    check(after == before, f"the safety stage launched port kernels: "
          f"{before} -> {after}")
    secs, records, metrics = runs[0][:3]
    ms = np.array([r["s"] for r in records]) * 1e3
    exp = np.array([r["expansions"] for r in records])
    solved = np.array([r["states"] > 0 for r in records])
    cap = PlannerConfig().max_expansions
    cls, k = np.empty(len(records), object), 0
    where = {r["id"]: i for i, r in enumerate(records)}
    for sub, _, n in CORPUS:
        cls[[where[i] for i in ids[k:k + n]]] = sub
        k += n
    rec = {
        "scenarios": len(ids), "solved": int(solved.sum()),
        "colliding": metrics["num_collisions"],
        "traffic": "synthetic: write_labeled_corpus(seed=0)",
        # the reference's corpus (PARITY.md): 315, 69 and 165 solved,
        # 18, 3 and 4 ms a plan on average, no search at the cap
        "classes": {sub: {
            "scenarios": n, "solved": int(solved[cls == sub].sum()),
            "capped": int((exp[cls == sub] >= cap).sum()),
            "plan_ms_mean": float(ms[cls == sub].mean())}
            for sub, _, n in CORPUS},
        "metrics": {k: metrics[k] for k in (
            "success_rate", "collision_rate", "safe_driving_rate",
            "avg_trajectory_length", "avg_travel_time")},
        "stage_s": {"write_corpus": t_corpus, **secs, "plots": t_plots},
        "rerun_stage_s": runs[1][0],
        "scenarios_per_s": len(ids) / sum(secs.values()),
        "plan_ms_per_scenario": {"median": float(np.median(ms)),
                                 "p90": float(np.percentile(ms, 90)),
                                 "max": float(ms.max()),
                                 "unsolved_total": float(ms[~solved].sum())},
        "expansions": {"median": float(np.median(exp)),
                       "max": int(exp.max()),
                       "capped": int((exp >= cap).sum())},
        "files_compared": len(runs[0][4]),
        "card_detections": card_runs, "plots": pngs,
        "launches": after, "phase_s": time.perf_counter() - t_phase,
        "host": "the card machine's CPU", "card": card}
    log(json.dumps({"safety_pipeline": rec}))
    return rec

# the torchrun variables of a rank (parallel.sharding.TORCHRUN_ENV and
# LOCAL_WORLD_SIZE)
RANK_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")


def free_port():
    """A localhost port that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(world, argv, timeout, env=None, cwd=None):
    """Run the command `argv` as `world` processes with the torchrun
    environment of one host (a free localhost port; `world` 1 runs it
    once without that environment, as one process runs). Waits at most
    `timeout` seconds in all and kills every process still running then;
    a launch whose rank 0 found the port taken is made once more on
    another. Returns [(exit code, stdout, stderr)] by rank, -9 for a
    killed process. Output goes through files, so that no rank blocks on
    a full pipe while another waits for it in a collective."""
    base = {k: v for k, v in (env or os.environ).items() if k not in RANK_ENV}
    for attempt in range(2):
        port = free_port()
        procs = []
        for r in range(world):
            e = dict(base)
            if world > 1:
                e.update(WORLD_SIZE=str(world), RANK=str(r),
                         LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            procs.append((subprocess.Popen(argv, env=e, cwd=cwd, stdout=out,
                                           stderr=err), out, err))
        deadline = time.monotonic() + timeout
        results = []
        for p, out, err in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for q, _, _ in procs:
                    q.kill()
                p.wait()
            texts = []
            for f in (out, err):
                f.seek(0)
                texts.append(f.read())
                f.close()
            results.append((p.returncode, *texts))
        taken = any("EADDRINUSE" in err or "address already in use" in err
                    for _, _, err in results)
        if not (taken and attempt == 0):
            return results


def rank_run(report, module, args):
    """One rank of a launch (`python3 chip_smoke.py --rank-run REPORT
    MODULE ARGS...`): run the CLI `MODULE`'s main(ARGS) in this process
    and write to REPORT ("{rank}" in it replaced by the rank) what the
    run wrote (every PNG through data.kitti.save_image, every .npy
    through numpy.save, by path), the port's kernel launches by kernel
    and by (kernel, shape, dtype), and the patch that a patch CLI's
    epoch loop returned on this rank (as a list). Needs no card."""
    import collections
    import importlib
    import threading

    import numpy as np
    sys.path.insert(0, ROOT)
    from eval_driving_safety_tpu_torch.data import kitti as K
    from eval_driving_safety_tpu_torch.ops import _cuda
    cli = importlib.import_module(module)
    writes, lock, patches = collections.Counter(), threading.Lock(), []
    save_image, save_npy = K.save_image, np.save

    def counted(fn):
        def call(path, *a, **k):
            with lock:
                writes[os.path.abspath(str(path))] += 1
            return fn(path, *a, **k)
        return call
    K.save_image, np.save = counted(save_image), counted(save_npy)
    if hasattr(cli, "train_patch"):
        train_patch = cli.train_patch

        def recorded(*a, **k):
            patches.append(train_patch(*a, **k))
            return patches[-1]
        cli.train_patch = recorded
    _cuda.reset_launches()
    cli.main(args)
    rank = int(os.environ.get("RANK", "0"))
    with open(report.replace("{rank}", str(rank)), "w") as f:
        json.dump({"rank": rank, "writes": dict(writes),
                   "launches": dict(_cuda.launches),
                   "launch_shapes": [[k, list(s), str(dt), n] for (
                       k, s, dt), n in _cuda.launch_shapes.items()],
                   "patch": [p.cpu().tolist() for p in patches]}, f)
    return 0


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of `obj` for the block, and restore them after."""
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


def dsgn_first_step(data, dev, scale, depth_dir=None):
    """The DSGN sweep as the CLI sets it up at --batch 2 over the frames
    000001-2 of `data` (seeded weights at `scale`, depth ground truth from
    `depth_dir` or none): (clean left, clean right, loss(rows, left,
    right), step(rows, clean, sign) -> the first iterate's saved uint8
    RGB pixels, the module whose `global_sum` the loss calls, each frame's
    saved size)."""
    from argparse import Namespace

    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack import objectives as O
    from eval_driving_safety_tpu_torch.cli.common import (make_dsgn_cfg,
                                                         make_dsgn_model)
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, dsgn_boxes3d, prepare_dsgn_batch_u8)
    from eval_driving_safety_tpu_torch.models import rpn3d_loss
    cfg = make_dsgn_cfg(Namespace(tiny=False, scale=scale, remat=False))
    model = make_dsgn_model(Namespace(ckpt=None), cfg, dev)
    ds = KittiStereoDataset(data)
    samples = [ds.get(0), ds.get(1)]
    b = prepare_dsgn_batch_u8(samples, cfg.input, depth_dir=depth_dir)
    g = dsgn_boxes3d(samples)
    mean, std = (torch.tensor(np.asarray(v) * 255.0, dtype=torch.float32,
                              device=dev)
                 for v in (cfg.input.mean, cfg.input.std))

    def put(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(dev)
    calib = [put(b[k]) for k in ("f_u", "baseline", "c_u", "c_v")]
    depth, boxes = put(b["depth_gt"]), put(g["boxes3d"])
    num = put(g["num_boxes"], torch.int64)

    def loss(rows, vl, vr):
        out = model((vl - mean) / std, (vr - mean) / std,
                    *(c[rows] for c in calib))
        return O.total_loss(out, depth[rows], boxes[rows], num[rows], cfg)

    def step(rows, clean, sign):          # the default unit step
        return torch.clamp(clean + sign, 0.0, 255.0).to(torch.uint8)
    return (put(b["im_left_u8"]).float(), put(b["im_right_u8"]).float(),
            loss, step, rpn3d_loss, b["orig_hw"])


def srcnn_first_step(data, dev, tiny=False):
    """The Stereo R-CNN sweep as the CLI sets it up at --batch 2 (bf16,
    seeded weights, the draws of seed 11 for the batch), in v-space, as
    `dsgn_first_step` returns it."""
    from argparse import Namespace

    import torch
    from eval_driving_safety_tpu_torch.cli.common import (make_srcnn_cfg,
                                                         make_srcnn_model)
    from eval_driving_safety_tpu_torch.cli.pgd_attack import SRCNN_DRAW_SEED
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, quantize_v_rgb_u8,
        srcnn_cleanv_device)
    from eval_driving_safety_tpu_torch.models import stereo_rcnn as M
    cfg = make_srcnn_cfg(Namespace(tiny=tiny), default_bf16=True,
                         default_s2d=True)
    model, uncert = make_srcnn_model(Namespace(ckpt=None), cfg, dev)
    ds = KittiStereoDataset(data)
    b = prepare_srcnn_batch_u8([ds.get(0), ds.get(1)], cfg.input)
    gt = {k: v.to(dev) for k, v in M.make_gt_batch(
        b["objects"], b["calibs"], cfg, image_scale=b["scales"]).items()}
    draws = model.sample_draws(2, torch.Generator(device=dev).manual_seed(
        SRCNN_DRAW_SEED))

    def put(x):
        return torch.as_tensor(x).to(dev)
    weights = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                      "wmask")}
    means = torch.tensor(cfg.input.pixel_means_bgr, dtype=torch.float32,
                         device=dev)
    cb = put(b["c255"])[:, None, None, None]

    def loss(rows, vl, vr):
        out = model(vl * cb[rows] - means, vr * cb[rows] - means,
                    gt={k: v[rows] for k, v in gt.items()},
                    draws=type(draws)(*(d[rows] for d in draws)),
                    mode="attack")
        return M.total_attack_loss(out.losses, uncert)

    # the default step of one BGR pixel, in v-space, and its bounds
    scale = (weights["den_h"] * weights["den_w"]).float()[:, None, None,
                                                            None]

    c255 = put(b["c255"])

    def step(rows, clean, sign):
        return quantize_v_rgb_u8(torch.clamp(
            clean + scale[rows] * sign, torch.zeros_like(scale[rows]),
            255.0 * scale[rows]), c255[rows])
    return (srcnn_cleanv_device(weights, put(b["im_left_u8"])),
            srcnn_cleanv_device(weights, put(b["im_right_u8"])), loss, step,
            M, b["net_hw"])


def first_step_frames(setup):
    """A sweep's first iterate, in this process, with its two rows
    computed as one batch and with each row computed alone with the
    batch's normalizers (each row's counts recorded in a first pass, their
    sums returned in a second; row means over both rows): {(frame id,
    right view): (batched, alone)}, the saved (h, w, 3) uint8 RGB pixels
    of each, as one process and as two ranks write them at iteration 1.
    `setup` is `dsgn_first_step`'s or `srcnn_first_step`'s."""
    import torch
    clean_l, clean_r, loss, step, module, sizes = setup

    def signs(rows):
        vl, vr = (c[rows].detach().requires_grad_(True)
                  for c in (clean_l, clean_r))
        return [step(rows, c[rows], torch.sign(g)) for c, g in zip(
            (clean_l, clean_r), torch.autograd.grad(loss(rows, vl, vr),
                                                    (vl, vr)))]

    batched = signs(slice(0, 2))
    counts = {0: [], 1: []}
    for rank in (0, 1):
        with patched(module, global_sum=lambda x, r=rank: counts[r].append(
                x.detach().clone()) or x):
            signs(slice(rank, rank + 1))
    alone = []
    for rank in (0, 1):
        sums = iter([a + b for a, b in zip(counts[0], counts[1])])
        mean = {"global_mean": lambda x: x.sum() / (x.numel() * 2)} \
            if hasattr(module, "global_mean") else {}
        with patched(module, global_sum=lambda x: next(sums), **mean):
            alone.append(signs(slice(rank, rank + 1)))
    out = {}
    for row, fid in enumerate(("000001", "000002")):
        h, w = sizes[row]
        for side in (0, 1):
            out[(fid, bool(side))] = tuple(
                x[:h, :w].cpu().numpy()
                for x in (batched[side][row], alone[row][side][0]))
    return out


def first_step_run(detector, data, out, tiny=False):
    """`python3 chip_smoke.py --first-step DETECTOR DATA OUT [tiny]`:
    `first_step_frames` for the sweep of `detector` over DATA's first two
    frames in this process, with the CLIs' deterministic kernels, on the
    card (the CPU with `tiny`); saved to OUT (.npz, keys "<frame id>_<0
    left, 1 right>_<0 batched, 1 alone>")."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from eval_driving_safety_tpu_torch.cli.common import \
        use_deterministic_kernels
    dev = torch.device("cpu" if tiny else "cuda")
    use_deterministic_kernels(dev)
    setup = (dsgn_first_step(data, dev, "tiny" if tiny else "paper")
             if detector == "dsgn" else srcnn_first_step(data, dev, tiny))
    np.savez(out, **{f"{fid}_{int(right)}_{k}": pair[k]
                     for (fid, right), pair in first_step_frames(setup).items()
                     for k in (0, 1)})
    return 0


# phase 13's runs: (CLI module, flags); "OUT" is the run's directory
SPLIT_ITERS = 2
SPLIT_RUNS = {
    "dsgn_sweep": ("eval_driving_safety_tpu_torch.cli.pgd_attack", [
        "--detector", "dsgn", "--scale", "paper", "--iter", str(SPLIT_ITERS),
        "--batch", "2", "--out_prefix", "OUT/pgd"]),
    "dsgn_patch": ("eval_driving_safety_tpu_torch.cli.patch_attack", [
        "--detector", "dsgn", "--scale", "paper", "--epochs", "1",
        "--iters", "2", "--batch", "2", "--save_dir", "OUT/patch"]),
    "srcnn_sweep": ("eval_driving_safety_tpu_torch.cli.pgd_attack", [
        "--detector", "srcnn", "--iter", str(SPLIT_ITERS), "--batch", "2",
        "--out_prefix", "OUT/pgd"]),
}
ATTACK_KERNELS = ("psv_warp_fwd", "psv_warp_bwd", "depth_tap_conv_fwd",
                  "depth_tap_conv_bwd")


def tree_files(root):
    """Every file under `root`, relative to it."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if not f.startswith("report"))


def split_phase(tmp, card, phase2, dtype, tiny=False):
    """13. The batch split over torch.distributed (parallel/sharding.py)
    on phase 4's two frames at --batch 2: the DSGN signs sweep and the
    DSGN patch (1 epoch of 2 steps) at --scale paper and the Stereo R-CNN
    sweep at StereoRCNNConfig(), each as one process and as two gloo
    ranks sharing the card, all fresh processes (launch_ranks, rank_run;
    the two launches of a run at once). Gates: every rank exits 0; every
    file is written once, each frame's by its rank; the ranks' patches
    are the same bits, the file's; each DSGN rank launches K1-K4 at phase
    2's shapes (the per-rank batch of 1), no weight gradient, and Stereo
    R-CNN no port kernel. Prints whether the files equal the one
    process's, the differing pixels where they do not (cuDNN may pick
    other algorithms at batch 1 than at batch 2: not gated), and where a
    sweep's first step in a fresh process differs between the batch of 2
    and each row alone with the batch's normalizers (`first_step_run`),
    and whether those first iterates are the ones each wrote. One card runs at most 2
    ranks, over gloo: no speed-up. `tiny` rehearses the phase on the CPU
    at the tiny configs, where no port kernel launches."""
    import concurrent.futures as cf

    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.data.kitti import load_image_u8
    t_phase = time.perf_counter()
    data = os.path.join(tmp, "kitti")
    rec = {}
    for name, (module, flags) in SPLIT_RUNS.items():
        outs = [os.path.join(tmp, "split", name, f"w{w}") for w in (1, 2)]
        if tiny:
            flags = [{"paper": "tiny"}.get(f, f) for f in flags] + (
                ["--tiny"] if name.startswith("srcnn") else []) + [
                "--device", "cpu"]
        torch.cuda.empty_cache()

        def run(world):
            out = outs[world - 1]
            os.makedirs(out)
            t0 = time.perf_counter()
            res = launch_ranks(world, [
                sys.executable, os.path.abspath(__file__), "--rank-run",
                os.path.join(out, "report{rank}.json"), module,
                "--data_path", data] + [f.replace("OUT", out) for f in flags],
                timeout=300, cwd=ROOT)
            secs = time.perf_counter() - t0
            for r, (rc, _, err) in enumerate(res):
                check(rc == 0, f"split {name} w{world}: rank {r} exited "
                      f"{rc}:\n{err[-4000:]}")
            reports = []
            for r in range(world):
                with open(os.path.join(out, f"report{r}.json")) as f:
                    reports.append(json.load(f))
            return secs, reports, [o for _, o, _ in res]
        def predict():
            """`first_step_frames` in a fresh process, as the CLIs run."""
            npz = os.path.join(tmp, "split", name, "first_step.npz")
            res = launch_ranks(1, [
                sys.executable, os.path.abspath(__file__), "--first-step",
                name.split("_")[0], data, npz] + (["tiny"] if tiny else []),
                timeout=300, cwd=ROOT)
            check(res[0][0] == 0, f"split {name}: the first step exited "
                  f"{res[0][0]}:\n{res[0][2][-4000:]}")
            with np.load(npz) as z:
                return {(fid, right): (z[f"{fid}_{int(right)}_0"],
                                       z[f"{fid}_{int(right)}_1"])
                        for fid in ("000001", "000002")
                        for right in (False, True)}
        with cf.ThreadPoolExecutor(3) as ex:
            jobs = [ex.submit(run, 1), ex.submit(run, 2)] + (
                [ex.submit(predict)] if name.endswith("sweep") else [])
            (t1, _, log1), (t2, reports, log2) = (j.result()
                                                  for j in jobs[:2])
            first_step = jobs[2].result() if jobs[2:] else None
        out1, out2 = outs
        files = tree_files(out1)
        check(files == tree_files(out2) and files,
              f"split {name}: files {tree_files(out2)} != {files}")
        writes = [{os.path.relpath(p, out2): n
                   for p, n in rp["writes"].items()} for rp in reports]
        check(not set(writes[0]) & set(writes[1])
              and sorted([*writes[0], *writes[1]]) == files
              and set(writes[0].values()) | set(writes[1].values()) == {1},
              f"split {name}: writes {writes}, files {files}")
        shapes = [{(k, tuple(sh)): dt for k, sh, dt, _ in rp["launch_shapes"]}
                  for rp in reports]
        if tiny:
            pass
        elif name.startswith("dsgn"):
            for r, rp in enumerate(reports):
                check(all(rp["launches"][k] > 0 for k in ATTACK_KERNELS)
                      and rp["launches"]["depth_tap_conv_wgrad"] == 0
                      and set(shapes[r]) == phase2
                      and set(shapes[r].values()) == {str(dtype)},
                      f"split {name} rank {r}: launches {rp['launches']}, "
                      f"shapes {sorted(shapes[r])} != phase 2's")
        else:
            check(not any(n for rp in reports
                          for n in rp["launches"].values()),
                  f"split {name}: port kernels launched")
        diff = {}
        if name.endswith("patch"):
            check(not writes[1], f"split {name}: rank 1 wrote {writes[1]}")
            p0, p1 = (np.asarray(rp["patch"][0], np.float32)
                      for rp in reports)
            check(p0.tobytes() == p1.tobytes(),
                  f"split {name}: the ranks' patches differ")
            a, b = (np.load(os.path.join(o, "patch", "epoch1", "patch.npy"))
                    for o in (out1, out2))
            check(b[0].transpose(1, 2, 0).tobytes() == p0.tobytes(),
                  f"split {name}: rank 0's file is not its patch")
            diff = {"entries": int((a != b).sum()), "of": int(a.size),
                    "max_abs": float(np.abs(a - b).max())}
        else:
            for r, fid in enumerate(("000001", "000002")):
                check({os.path.basename(p) for p in writes[r]}
                      == {fid + ".png"}, f"split {name}: rank {r} wrote "
                      f"{sorted(writes[r])}")
            masks = {}
            for f in files:
                a, b = (load_image_u8(os.path.join(o, f))
                        for o in (out1, out2))
                masks[f] = (a != b).any(-1)
                if masks[f].any():
                    diff[f] = int(masks[f].sum())
            saved = {(fid, right): [load_image_u8(os.path.join(
                o, "pgd_iters_1", "image_3" if right else "image_2",
                fid + ".png")) for o in (out1, out2)]
                for (fid, right) in first_step}
            rec[name + "_first_step"] = {
                "predicted_pixels": int(sum(
                    (a != b).any(-1).sum() for a, b in first_step.values())),
                "iteration_1_pixels": int(sum(
                    (a != b).any(-1).sum() for a, b in saved.values())),
                # the batch of 2 as one process wrote it, the rows alone as
                # the two ranks did
                "batched_is_world1": all(np.array_equal(
                    first_step[k][0], saved[k][0]) for k in saved),
                "alone_is_world2": all(np.array_equal(
                    first_step[k][1], saved[k][1]) for k in saved)}
        rec[name] = {
            "bytes_equal": all(
                open(os.path.join(out1, f), "rb").read()
                == open(os.path.join(out2, f), "rb").read() for f in files),
            "files": len(files), "differing": diff,
            "world1_s": t1, "world2_s": t2,
            "rank_launches": [rp["launches"] for rp in reports],
            "world1_log": log1[0].strip().splitlines()[-2:],
            "rank0_log": log2[0].strip().splitlines()[-2:]}
    rec.update(phase_s=time.perf_counter() - t_phase, card=card,
               note="one H100: world size <= 2 on one device, over gloo "
                    "(NCCL refuses two ranks on one device); checks the "
                    "split, shows no speed-up; each run's one process and "
                    "two ranks at once")
    log(json.dumps({"split": rec}))
    return rec


# -------------------------------------------------------------- phase 14

ORBAX_FIXTURE = os.path.join("tests", "torch_fixtures", "orbax_dsgn_tiny")


def leaf_digests(tree, prefix=""):
    """{path: {"shape", "dtype", "sha256"}} of every array leaf of a
    checkpoint tree (dicts and lists of numpy arrays or torch tensors;
    bfloat16 by its bits) and {path: {"value"}} of every scalar; None
    leaves are left out. A path joins the keys and indices with "/"."""
    import hashlib
    import numpy as np
    import torch
    if tree is None:
        return {}
    if isinstance(tree, (bool, int, float, str)):
        return {prefix: {"value": tree}}
    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            out.update(leaf_digests(v, f"{prefix}/{k}" if prefix
                                    else str(k)))
        return out
    if isinstance(tree, torch.Tensor):
        dtype = str(tree.dtype).removeprefix("torch.")
        arr = (tree.view(torch.int16) if tree.dtype == torch.bfloat16
               else tree).numpy()
    else:
        arr = np.asarray(tree)
        dtype = str(arr.dtype)
    return {prefix: {"shape": list(arr.shape), "dtype": dtype,
                     "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}}


def orbax_phase(tmp, dev, card):
    """Phase 14: the JAX DSGN trainer's orbax checkpoint committed at
    ORBAX_FIXTURE (DSGNConfig.tiny(), see its make script): (a) read by
    utils.orbax_read through the system's libzstd, every leaf equal to the
    digests the JAX package's restore gave, the read timed on the host;
    (b) the attack CLI on it at --scale tiny, 1 iteration on the card,
    launching K1-K4 dx at the tiny config's shapes and no weight gradient;
    (c) the training CLI resumed from a copy of it: it starts at epoch N+1
    with the optax state's step count and writes epoch{N+1}/checkpoint.pt,
    launching all five kernels."""
    import shutil
    import numpy as np
    from eval_driving_safety_tpu_torch.cli.train_detector import \
        main as train_main
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.utils import zstd
    from eval_driving_safety_tpu_torch.utils.checkpoint import (
        is_orbax_checkpoint, latest_epoch_dir, restore_checkpoint)
    from eval_driving_safety_tpu_torch.utils.orbax_read import read_orbax
    fixture = os.path.join(ROOT, ORBAX_FIXTURE)
    epoch_dir = latest_epoch_dir(fixture)
    check(epoch_dir is not None and is_orbax_checkpoint(epoch_dir),
          f"no orbax epoch directory in {fixture}")
    n = int(os.path.basename(epoch_dir).removeprefix("epoch"))
    with open(os.path.join(fixture, "digests.json")) as f:
        want = json.load(f)

    # (a) the read, warm, median of 5
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        tree = read_orbax(epoch_dir)
        times.append(time.perf_counter() - t0)
    read_s = sorted(times)[2]
    got = leaf_digests(tree)
    bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    check(not bad, f"orbax read: {len(bad)} leaves differ from the "
          f"digests, e.g. {bad[:4]}")
    with open("/proc/self/maps") as f:
        lib_paths = sorted({ln.split()[-1] for ln in f if "libzstd" in ln})
    disk = sum(os.path.getsize(os.path.join(d, name))
               for d, _, names in os.walk(epoch_dir) for name in names)
    arrays = sum(int(np.prod(v["shape"])) * np.dtype(
        "int16" if v["dtype"] == "bfloat16" else v["dtype"]).itemsize
        for v in got.values() if "shape" in v)
    count = int(tree["opt_state"][1]["inner_state"][0]["count"])
    check(tree["epoch"] == n, f"fixture epoch {tree['epoch']} != {n}")

    # (b) the attack on it, 1 iteration at the tiny scale
    ids = ["000001", "000002"]
    data = os.path.join(tmp, "orbax_kitti")
    write_frames(data, ids)
    _cuda.reset_launches()
    t_attack, losses, out = run_cli([
        "--data_path", data, "--detector", "dsgn", "--scale", "tiny",
        "--iter", "1", "--batch", "1", "--device", str(dev),
        "--ckpt", epoch_dir,
        "--out_prefix", os.path.join(tmp, "orbax_attack", "dsgn_pgd")])
    launches = dict(_cuda.launches)
    shapes = {(k, sh) for k, sh, _ in _cuda.launch_shapes}
    tiny = DSGNConfig.tiny()
    psv = {(1, tiny.num_depth_planes, tiny.height // 4, tiny.width // 4,
            tiny.feature_channels)}
    check(f"loaded DSGN weights from {epoch_dir} (the JAX trainer's orbax "
          "checkpoint)" in out and len(losses) == len(ids) and all(
              math.isfinite(v) for l in losses for v in l),
          f"the attack on the orbax checkpoint: losses {losses}")
    check(attack_launches_ok(launches)
          and {sh for k, sh in shapes if k.startswith("psv")} == psv
          and {sh for k, sh in shapes if k.startswith("depth_tap")}
          == set(depthconv_shapes(tiny)),
          f"the attack on the orbax checkpoint: launches {launches} at "
          f"{sorted(shapes)}, expected K1-K4 dx at the tiny shapes")

    # (c) the trainer resumed from a copy of it
    ck = os.path.join(tmp, "orbax_ckpts")
    copy = os.path.join(ck, os.path.basename(epoch_dir))
    shutil.copytree(epoch_dir, copy)
    _cuda.reset_launches()
    t_resume, _, out = run_cli([
        "--data_path", data, "--detector", "dsgn", "--tiny", "--epochs", "1",
        "--ckpt_every", "1", "--ckpt_dir", ck, "--resume",
        "--device", str(dev)], train_main)
    train_launches = dict(_cuda.launches)
    resumed = train_losses(out)
    saved = os.path.join(ck, f"epoch{n + 1}")
    check(f"resumed from {copy} (epoch {n})" in out
          and sorted(resumed) == [n + 1] and math.isfinite(resumed[n + 1])
          and os.path.isfile(os.path.join(saved, "checkpoint.pt")),
          f"the resume from the orbax checkpoint: losses {resumed}")
    c = restore_checkpoint(saved)
    steps = len(ids)
    check(c["epoch"] == n + 1 and c["opt_state"]["count"] == count + steps
          and all(int(st["step"]) == count + steps
                  for st in c["opt_state"]["adamw"]["state"].values()),
          f"epoch{n + 1}: epoch {c['epoch']}, count "
          f"{c['opt_state']['count']}, expected {count} + {steps}")
    check(all(v > 0 for v in train_launches.values()),
          f"the resumed training launches {train_launches}")
    rec = {
        "fixture": ORBAX_FIXTURE, "epoch_dir": os.path.basename(epoch_dir),
        "leaves": len(got), "zstd_library": lib_paths,
        "zstd_version": zstd.version(), "disk_bytes": disk,
        "array_bytes": arrays, "read_ms": read_s * 1e3,
        "read_ms_all": [t * 1e3 for t in times],
        "disk_MB_per_s": disk / read_s / 1e6,
        "array_MB_per_s": arrays / read_s / 1e6,
        "attack_s": t_attack, "attack_losses": losses,
        "attack_launches": launches, "resume_s": t_resume,
        "resumed_losses": resumed, "count": count,
        "resumed_count": c["opt_state"]["count"],
        "train_launches": train_launches, "host": "the card machine's CPU",
        "card": card}
    log(json.dumps({"orbax": rec}))
    return rec


# -------------------------------------------------------------- phase 15

# the model axis's step on phase 4's first frame: 2 warm-up and 5 timed
# PGD steps a model after the counted one
MODEL_AXIS_TIMED = 5


def rank_depthconv_shapes(c, n):
    """The depth-conv launch shapes (B, D, N, C, F) of one forward of
    config `c` on each of `n` model ranks: the rank's planes and a halo
    of one on each side at the full, half and quarter volumes, and the
    voxel layers (on Z, computed alike on every rank) as one process has
    them."""
    whole = depthconv_shapes(c)
    return [(b, d // n + 2, hw, ci, f) for b, d, hw, ci, f in whole[:3]] \
        + whole[3:]


def rank_psv_shape(c, n):
    """K1's and K2's (B, D, H, W, C) on each of `n` model ranks."""
    return (1, c.num_depth_planes // n, c.height // 4, c.width // 4,
            c.feature_channels)


def model_axis_run(out, data, depth_dir, tiny=False):
    """`python3 chip_smoke.py --model-axis OUT DATA DEPTH_DIR [tiny]`: one
    process, or one rank of a launch (mesh (1, world): the world splits
    the planes), runs on the first frame of DATA (depth ground truth from
    DEPTH_DIR) one PGD step, the same step with remat (cfg.remat: the
    hourglass recomputed in the backward pass, its loss and image
    gradients compared bit for bit with the first's), then one patch
    step, of the fast DSGN at DSGNConfig.full() (seed 0) and of the
    compat model at the upstream default arch (random_compat_weights),
    bf16, on the card (the CPU and the tiny config and arch with `tiny`),
    each with the launch counts and the collectives' traffic set to 0
    just before it and read just after; then times the PGD step
    (median of MODEL_AXIS_TIMED after 2 warm-ups) and reads the peak
    memory. Writes OUT.npz (the losses, every depth map, both images'
    gradient signs, the new patch) and OUT.json (launches, shapes, the
    collectives' traffic and the peak memory of each PGD step, times,
    memory), "{rank}" in OUT replaced by the rank."""
    import dataclasses

    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from eval_driving_safety_tpu_torch.attack import objectives as O
    from eval_driving_safety_tpu_torch.attack.patch import (
        init_patch, patch_update_step, sample_patch_centers)
    from eval_driving_safety_tpu_torch.cli.common import \
        use_deterministic_kernels
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, dsgn_boxes3d, prepare_dsgn_batch_u8)
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.dsgn_compat import (
        DSGNCompat, DSGNCompatArch)
    from eval_driving_safety_tpu_torch.ops import _cuda
    from eval_driving_safety_tpu_torch.parallel import sharding as S
    from eval_driving_safety_tpu_torch.parallel import volume as V
    mesh = S.init_process_group("cpu" if tiny else "cuda")
    mesh = dataclasses.replace(S.make_mesh(1, mesh.world),
                               device=mesh.device)
    out = out.replace("{rank}", str(mesh.rank))
    dev = mesh.device
    use_deterministic_kernels(dev)
    shard = V.constrain_psv(mesh)
    cfg = DSGNConfig.tiny() if tiny else DSGNConfig.full()
    sample = KittiStereoDataset(data).get(0)
    b = prepare_dsgn_batch_u8([sample], cfg.input, depth_dir=depth_dir)
    g = dsgn_boxes3d([sample])

    def put(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(dev)
    mean, std = (put(np.asarray(v, np.float32) * 255.0)
                 for v in (cfg.input.mean, cfg.input.std))
    calib = [put(b[k]) for k in ("f_u", "baseline", "c_u", "c_v")]
    depth, boxes = put(b["depth_gt"]), put(g["boxes3d"])
    num = put(g["num_boxes"], torch.int64)
    clean = [put(b[k]).float() for k in ("im_left_u8", "im_right_u8")]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    arrays, rec = {}, {"world": mesh.world, "rank": mesh.rank}
    for kind in ("dsgn", "compat"):
        if kind == "dsgn":
            model = DSGN(cfg, volume_constraint=shard).init_weights(0)
        else:
            arch = DSGNCompatArch.tiny() if tiny else DSGNCompatArch()
            model = DSGNCompat(cfg, arch, volume_constraint=shard)
            model.load_state_dict(random_compat_weights(
                cfg, arch).state_dict())
        model = model.to(dev).requires_grad_(False).eval()
        outs = []

        def loss_of(vl, vr):
            out = model((vl - mean) / std, (vr - mean) / std, *calib)
            outs.append(out)
            return O.total_loss(out, depth, boxes, num, cfg)

        def pgd_step():
            vl, vr = (c.clone().requires_grad_(True) for c in clean)
            loss = loss_of(vl, vr)
            return (loss.detach(), *torch.autograd.grad(loss, (vl, vr)))

        def counted_pgd_step():
            """One PGD step with the launch counts and the collectives'
            traffic set to 0 just before it: its results, launches,
            shapes, traffic and peak memory."""
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_launches()
            V.reset_traffic()
            res = pgd_step()
            sync()
            return res, {
                "pgd_launches": dict(_cuda.launches),
                "pgd_launch_shapes": [[k, list(sh), str(dt), n] for (
                    k, sh, dt), n in _cuda.launch_shapes.items()],
                "traffic": {k: dict(v) for k, v in V.traffic.items()},
                "pgd_peak_mem_GiB": (torch.cuda.max_memory_allocated(dev)
                                     / 2 ** 30 if dev.type == "cuda"
                                     else None)}
        r = rec[kind] = {"score_abs_max": []}
        hooks = [m.register_forward_hook(
            lambda m, a, y: r["score_abs_max"].append(float(
                y.detach().abs().max()))) for m in model.modules()
            if type(m).__name__ == "Score3D"]
        (loss, gl, gr), counted = counted_pgd_step()
        for h in hooks:
            h.remove()
        r.update(counted)
        arrays[kind + "_loss"] = loss.float().cpu().numpy()
        for i, dp in enumerate(outs[-1]["depth_preds"]):
            arrays[f"{kind}_depth{i}"] = dp.detach().float().cpu().numpy()
        arrays[kind + "_sign_l"], arrays[kind + "_sign_r"] = (
            torch.sign(x).to(torch.int8).cpu().numpy() for x in (gl, gr))
        del outs[:]
        # the same step with the hourglass recomputed in the backward pass
        # (cfg.remat, the CLIs' --remat): the loss and both image
        # gradients the same bits, the hourglass's K3 and halo exchanges
        # run again inside the backward
        model.cfg = dataclasses.replace(cfg, remat=True)
        (rloss, rgl, rgr), r["remat"] = counted_pgd_step()
        model.cfg = cfg
        r["remat"]["same_bits"] = {
            "loss": torch.equal(rloss, loss), "grad_l": torch.equal(rgl, gl),
            "grad_r": torch.equal(rgr, gr)}
        del rloss, rgl, rgr, outs[:]
        _, radius, patch = init_patch(cfg.height, 0.2)
        centers = sample_patch_centers(
            torch.Generator().manual_seed(1), 1, cfg.height, cfg.width,
            radius)
        _cuda.reset_launches()
        new_patch, ploss = patch_update_step(
            loss_of, patch.to(dev) * 255.0, *clean, *centers, alpha=1e3,
            eps=8.0)
        sync()
        r["patch_launches"] = dict(_cuda.launches)
        arrays[kind + "_patch"] = new_patch.cpu().numpy()
        arrays[kind + "_patch_loss"] = ploss.float().cpu().numpy()
        del outs[:], loss, gl, gr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(2 + MODEL_AXIS_TIMED):
            sync()
            t0 = time.perf_counter()
            pgd_step()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            del outs[:]
        r["step_ms"] = times[2:]
        r["step_ms_median"] = sorted(times[2:])[MODEL_AXIS_TIMED // 2]
        r["peak_mem_GiB"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else None)
        del model
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(rec, f)
    S.destroy_process_group()
    return 0


def model_axis_kernels(c, dev, per):
    """Phase 2 at the model axis's new shapes (two ranks, `c`'s dtype):
    K1 and K2 at a rank's planes, K3, K4 dx and the weight gradient at a
    rank's planes and halo (rank_depthconv_shapes), held against their
    plain versions and timed into `per`."""
    import dataclasses
    n = 2
    planes = rank_psv_shape(c, n)[1]
    check_psv(dataclasses.replace(c, num_depth_planes=planes), c.dtype, dev,
              per)
    check_depthconv(c, c.dtype, dev, per, {}, shapes=[
        sh for sh in rank_depthconv_shapes(c, n)
        if sh not in depthconv_shapes(c)])


def model_axis_phase(tmp, card, dev, per, tiny=False):
    """15. The model axis (parallel/volume.py): DSGN's plane-sweep volume
    split by depth plane over two gloo ranks sharing the card, mesh
    (1, 2), at DSGNConfig.full() bf16 on phase 4's first frame. (a) One
    PGD step and one patch step of the fast DSGN in one process and on
    the two ranks (`model_axis_run`, fresh processes, one after the
    other): the loss's relative difference and every depth map within
    2^-7 (x the largest), the share of image-gradient signs that flip
    (at most a quarter), the ranks' signs, losses and patches the same
    bits; each rank launches K1, K2, K3 and K4 dx at its predicted
    per-rank shapes (`rank_psv_shape`, `rank_depthconv_shapes`), never
    the weight gradient, where phase 2 held K1-K4 dx against their plain
    versions (`model_axis_kernels`); (b) the compat model's steps the same
    way at the upstream default arch (K1 and K2 only), its depth map
    held by its mean error (2^-10 x the largest) and the share of pixels
    past 2^-7 (5%), its near-argmax soft-argmin moving a pixel across
    planes on a rounding; (c)
    parallel.dryrun at world 4 on the (2, 2) mesh at --scale dryrun.
    Prints the `model_axis` line: each run's step time, the halo and
    gather bytes and host ms a PGD step, peak memory per rank. One card
    cannot show a speed-up. `per` holds phase 2's bf16 records and
    `model_axis_kernels`'. `tiny` rehearses the phase on the CPU at the
    tiny config, where no kernel launches and none is held."""
    import numpy as np
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    t_phase = time.perf_counter()
    cfg = DSGNConfig.tiny() if tiny else DSGNConfig.full()
    data = os.path.join(tmp, "kitti")
    depth_dir = os.path.join(tmp, "depth_gt")
    if not os.path.isdir(depth_dir):
        write_depth_gt(depth_dir, ["000001"])
    runs = {}
    for world in (1, 2):
        out = os.path.join(tmp, "model_axis", f"w{world}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        t0 = time.perf_counter()
        res = launch_ranks(world, [
            sys.executable, os.path.abspath(__file__), "--model-axis",
            out + "_{rank}", data, depth_dir] + (["tiny"] if tiny else []),
            timeout=400, cwd=ROOT)
        secs = time.perf_counter() - t0
        for r, (rc, _, err) in enumerate(res):
            check(rc == 0, f"model axis w{world}: rank {r} exited {rc}:\n"
                  f"{err[-4000:]}")
        runs[world] = [
            (dict(np.load(f"{out}_{r}.npz")),
             json.load(open(f"{out}_{r}.json"))) for r in range(world)]
        runs[world].append(secs)
    one, (a0, j0), (a1, j1) = runs[1][0], *runs[2][:2]
    failures = []

    def gate(ok, what):
        if not ok:
            failures.append(what)
    per_rank_dc = set(rank_depthconv_shapes(cfg, 2))
    per_rank_psv = rank_psv_shape(cfg, 2)
    rec = {"card": card, "mesh": [1, 2], "launch_s": {
        "one_process": runs[1][-1], "two_ranks": runs[2][-1]}}
    for kind in ("dsgn", "compat"):
        keys = [k for k in a0 if k.startswith(kind + "_")]
        check(all(np.array_equal(a0[k], a1[k]) for k in keys),
              f"model axis {kind}: the two ranks' results differ in "
              f"{[k for k in keys if not np.array_equal(a0[k], a1[k])]}")
        w1 = one[0]
        loss_rel = float(abs(a0[kind + "_loss"] - w1[kind + "_loss"])
                         / abs(w1[kind + "_loss"]))
        depth = {}
        for k in keys:
            if "_depth" in k:
                err = np.abs(a0[k] - w1[k]) / np.abs(w1[k]).max()
                depth[k.split("_")[-1]] = {
                    "max": float(err.max()),
                    "p99_9": float(np.quantile(err, 0.999)),
                    "mean": float(err.mean()),
                    "share_over_2^-7": float((err > 2.0 ** -7).mean())}
        depth_err = max(d["max"] for d in depth.values())
        signs = [(a0[k] != w1[k]) for k in (kind + "_sign_l",
                                            kind + "_sign_r")]
        flips = float(sum(s.sum() for s in signs)
                      / sum(s.size for s in signs))
        patch_diff = np.abs(a0[kind + "_patch"] - w1[kind + "_patch"])
        ploss_rel = float(abs(a0[kind + "_patch_loss"]
                              - w1[kind + "_patch_loss"])
                          / abs(w1[kind + "_patch_loss"]))
        # the compat model's random-weight scores reach |109| in bf16
        # (steps of 0.5), so its soft-argmin is near an argmax and a
        # rounding may move a pixel across planes: its depth maps are
        # held by their mean error and the share of pixels past 2^-7
        depth_ok = depth_err <= 2.0 ** -7 if kind == "dsgn" else all(
            d["mean"] <= 2.0 ** -10 and d["share_over_2^-7"] <= 0.05
            for d in depth.values())
        gate(loss_rel <= 2.0 ** -7 and ploss_rel <= 2.0 ** -7
             and depth_ok and flips <= 0.25,
             f"model axis {kind}: loss {loss_rel:.3g}, patch loss "
             f"{ploss_rel:.3g} relative, depth {depth_err:.3g} x the "
             f"largest, {flips:.3g} of the signs flip")
        ranks = [j0[kind], j1[kind]]
        if not tiny:
            for r, jr in enumerate(ranks):
                pgd, patch = jr["pgd_launches"], jr["patch_launches"]
                shapes = {(k, tuple(sh)) for k, sh, _, _ in
                          jr["pgd_launch_shapes"]}
                if kind == "dsgn":
                    want = {("psv_warp_fwd", per_rank_psv),
                            ("psv_warp_bwd", per_rank_psv)} | {
                        (k, sh) for sh in per_rank_dc for k in (
                            "depth_tap_conv_fwd", "depth_tap_conv_bwd")}
                    ok = all(pgd[k] > 0 and patch[k] > 0
                             for k in ATTACK_KERNELS)
                else:
                    want = {("psv_warp_fwd", per_rank_psv),
                            ("psv_warp_bwd", per_rank_psv)}
                    ok = all(pgd[k] == 1 and patch[k] == 1 for k in
                             ("psv_warp_fwd", "psv_warp_bwd")) and not any(
                        pgd[k] or patch[k] for k in pgd
                        if k.startswith("depth_tap"))
                gate(ok and pgd["depth_tap_conv_wgrad"] == 0
                     and shapes == want,
                     f"model axis {kind} rank {r}: launches {pgd}, "
                     f"{patch}, shapes {sorted(shapes)} != {sorted(want)}")
                # with remat the hourglass's five stride-1 blocks run K3
                # again inside the backward, at the rank's shapes
                rm = jr["remat"]
                rshapes = {(k, tuple(sh)) for k, sh, _, _ in
                           rm["pgd_launch_shapes"]}
                gate(launches_are(rm["pgd_launches"], REMAT_PER_ITER[kind],
                                  1) and rshapes == want,
                     f"model axis {kind} rank {r} with remat: launches "
                     f"{rm['pgd_launches']} != {REMAT_PER_ITER[kind]}, "
                     f"shapes {sorted(rshapes)} != {sorted(want)}")
        same = {"one_process": [one[1][kind]["remat"]["same_bits"]],
                "two_ranks": [jr["remat"]["same_bits"] for jr in ranks]}
        gate(all(all(b.values()) for v in same.values() for b in v),
             f"model axis {kind}: a remat step's loss or image gradients "
             f"differ from the step without remat: {same}")

        def halos(jr):
            return {d: {m: jr["traffic"].get(f"halo_exchange.{d}", {}).get(
                m, 0) for m in ("calls", "bytes")} for d in ("fwd", "bwd")}
        rec[kind] = {
            "loss_one_process": float(w1[kind + "_loss"]),
            "loss_rel_diff": loss_rel, "depth_rel_err": depth_err,
            "depth_err_detail": depth,
            "score_abs_max": [jr["score_abs_max"] for jr in ranks],
            "score_abs_max_one_process": one[1][kind]["score_abs_max"],
            "sign_flip_share": flips,
            "patch_entries_differing": int((patch_diff > 0).sum()),
            "patch_entries": int(patch_diff.size),
            "patch_max_abs_diff": float(patch_diff.max()),
            "patch_max_step": float(np.abs(w1[kind + "_patch"]).max()),
            "patch_loss_rel_diff": ploss_rel,
            "step_ms_one_process": one[1][kind]["step_ms_median"],
            "step_ms_two_ranks": [jr["step_ms_median"] for jr in ranks],
            "step_ms_all": {"one_process": one[1][kind]["step_ms"],
                            "two_ranks": [jr["step_ms"] for jr in ranks]},
            "peak_mem_GiB_one_process": one[1][kind]["peak_mem_GiB"],
            "peak_mem_GiB_per_rank": [jr["peak_mem_GiB"] for jr in ranks],
            "traffic_per_pgd_step": [jr["traffic"] for jr in ranks],
            "rank_launches": [jr["pgd_launches"] for jr in ranks],
            "rank_patch_launches": [jr["patch_launches"] for jr in ranks],
            "remat": {
                "same_bits": same,
                "rank_launches": [jr["remat"]["pgd_launches"]
                                  for jr in ranks],
                "halo_per_pgd_step_per_rank": {
                    "no_remat": [halos(jr) for jr in ranks],
                    "remat": [halos(jr["remat"]) for jr in ranks]},
                "pgd_peak_mem_GiB_per_rank": {
                    "no_remat": [jr["pgd_peak_mem_GiB"] for jr in ranks],
                    "remat": [jr["remat"]["pgd_peak_mem_GiB"]
                              for jr in ranks]},
                "pgd_peak_mem_GiB_one_process": {
                    "no_remat": one[1][kind]["pgd_peak_mem_GiB"],
                    "remat": one[1][kind]["remat"]["pgd_peak_mem_GiB"]}}}
    # a rank's kernels a PGD step: phase 2's times at the rank's shapes
    if not tiny:
        counts = launch_counts(j0["dsgn"]["pgd_launch_shapes"])
        timed_here = {k: v for k, v in per.items() if k[2] == cfg.dtype
                      and (k[0], k[1]) in counts}
        gate({(k, s) for k, s, _ in timed_here} == set(counts),
             f"model axis: the ranks' shapes {sorted(counts)} are not all "
             f"timed: {sorted(timed_here)}")
        rec["rank_kernels_per_pgd_step"] = {
            k: dict(max_abs_err=v["err"], launches=v["launches_per_iter"],
                    **{m: v[m] for m in TIME_KEYS},
                    bound_ms=bound(v, cfg.dtype)[0],
                    bound_by=bound(v, cfg.dtype)[1])
            for k, v in per_iteration(timed_here, counts,
                                      cfg.dtype).items()}
        rec["rank_kernel_detail"] = detail_rows(
            {k: v for k, v in timed_here.items()
             if k[1] not in depthconv_shapes(cfg)}, counts)
    # (c) the dry run at world 4 on the (2, 2) mesh
    t0 = time.perf_counter()
    res = launch_ranks(4, [
        sys.executable, "-m", "eval_driving_safety_tpu_torch.parallel.dryrun",
        "--scale", "tiny" if tiny else "dryrun"] + (
            ["--device", "cpu"] if tiny else []), timeout=300, cwd=ROOT)
    for r, (rc, _, err) in enumerate(res):
        gate(rc == 0, f"dryrun rank {r} exited {rc}:\n{err[-4000:]}")
    lines = res[0][1].strip().splitlines()
    if lines and lines[-1].startswith("dryrun_multichip(4): DSGN mesh="
                                      "{'data': 2, 'model': 2}") \
            and lines[-1].endswith("ckpt-restore OK"):
        rec["dryrun"] = dict(json.loads(lines[-2])["dryrun"],
                             launch_s=time.perf_counter() - t0,
                             line=lines[-1])
    else:
        gate(False, f"dryrun printed {lines[-2:]}")
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["note"] = ("one H100: the ranks share it over gloo (NCCL refuses "
                   "two ranks on one device), so no speed-up can be shown")
    log(json.dumps({"model_axis": rec}))
    check(not failures, "; ".join(failures))
    return rec


# -------------------------------------------------------------- phase 16

# Adam steps of each story's overfit: the JAX script's 400, at both
# scales; and a story's detections (clean and attacked)
DEMO_STEPS = 400
DEMO_DETECTS = 2


def demo_story(scale, dev, steps):
    """One run of the full-story CLI (examples/end_to_end_demo.py's
    `main`) at `scale`: its METRICS line, the stats `run` fills, the
    kernel launches the wrappers recorded over it (counts, and
    (kernel, shape, dtype)) and its wall time. Fails unless it exits 0
    (the clean detection found the car) with DONE."""
    from eval_driving_safety_tpu_torch.examples import end_to_end_demo
    from eval_driving_safety_tpu_torch.ops import _cuda
    stats = {}
    buf = io.StringIO()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = end_to_end_demo.main(["--scale", scale, "--steps", str(steps),
                                   "--device", dev.type], stats=stats)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    lines = [ln[len("METRICS "):] for ln in out.splitlines()
             if ln.startswith("METRICS ")]
    check(rc == 0 and len(lines) == 1 and out.splitlines()[-1] == "DONE",
          f"the {scale} story exited {rc}: {out[-1500:]}")
    return dict(line=lines[0], metrics=json.loads(lines[0]), stats=stats,
                launches=dict(_cuda.launches),
                shapes=set(_cuda.launch_shapes), wall_s=wall, out=out)


def story_launches(steps, per_step, per_iter):
    """Each kernel's launches over a story: `steps` training steps at
    phase 5's counts a step, the attack's iterations at phase 4's a PGD
    iteration, and the two detections at phase 6's a predicted pair."""
    from eval_driving_safety_tpu_torch.examples.end_to_end_demo import \
        ATTACK
    iters = ATTACK["num_iters"]
    return {k: steps * per_step.get(k, 0) + iters * per_iter.get(k, 0)
            + DEMO_DETECTS * PREDICT_PER_PAIR.get(k, 0) for k in SOURCES}


def story_record(run, config):
    s, m = run["stats"], run["metrics"]
    return {
        "config": config, "steps": s["steps"], "losses": s["losses"],
        "train_ms_per_step": s["train_ms_per_step"],
        "detect_ms": 1e3 * s["detect_s"],
        "attacked_detect_ms": 1e3 * s["adv_detect_s"],
        "pgd_ms_per_iter": s["pgd_ms_per_iter"],
        "safety_host_ms": 1e3 * s["safety_s"],
        "clean": s["clean_detection"], "attacked": s["adv_detection"],
        "attack_losses": s["attack_losses"], "metrics": m,
        "flipped": m["adv"]["collision"] == 1 or m["adv"]["success"] == 0,
        "launches": run["launches"], "wall_s": run["wall_s"],
        "weights_sha256": s["weights_sha256"]}


def demo_phase(dev, card, per_step, per_iter, held):
    """16. The DSGN full story (examples/end_to_end_demo.py): overfit the
    detector on the synthetic planted-car scene, detect, PGD-attack,
    plan and collision-check. (a) The tiny story (DSGNConfig.tiny(),
    bf16) twice: the same METRICS line and trained weights' digest, and
    tests/test_dsgn_end_to_end.py's conditions (clean score >= 0.5 and
    error < 3 m, clean plan found without collision, the attack's loss
    ascends, the attacked plan collides or is not found). (b) The train
    story (DSGNConfig(), the trainer's config) once: the car found within
    3 m, the clean plan found without collision, the loss ascends; the
    flip is printed, not gated. (c) Each story's launches equal
    `story_launches` (phase 5's a training step, phase 4's a PGD
    iteration, phase 6's a detection) at shapes phase 2 held, in bf16.
    Prints the `demo` line (stage times, losses, detections, metrics).
    Returns each story's launches."""
    t0 = time.perf_counter()
    runs = {}
    for name, scale in (("tiny", "tiny"), ("tiny_rerun", "tiny"),
                        ("train", "train")):
        run = demo_story(scale, dev, DEMO_STEPS)
        want = story_launches(DEMO_STEPS, per_step, per_iter)
        check(run["launches"] == want,
              f"the {name} story launched {run['launches']}, not {want}")
        unheld = {sh for sh in run["shapes"] if sh not in held}
        check(not unheld, f"the {name} story launched at shapes phase 2 "
              f"did not hold: {sorted(unheld)}")
        runs[name] = run
        log(run["out"].rstrip())
    a, b = runs["tiny"], runs["tiny_rerun"]
    check(a["line"] == b["line"] and a["stats"]["weights_sha256"]
          == b["stats"]["weights_sha256"],
          f"two tiny stories differ: {a['line']} / {b['line']}, weights "
          f"{a['stats']['weights_sha256']} / {b['stats']['weights_sha256']}")
    m = a["metrics"]
    check(m["clean_score"] >= 0.5 and m["clean_err"] < 3.0
          and m["clean"] == {"success": 1, "collision": 0}
          and m["attack_ascent"] > 0.0
          and (m["adv"]["collision"] == 1 or m["adv"]["success"] == 0),
          f"the tiny story: {m}")
    m = runs["train"]["metrics"]
    check(m["clean_err"] < 3.0
          and m["clean"] == {"success": 1, "collision": 0}
          and m["attack_ascent"] > 0.0, f"the train story: {m}")
    log(json.dumps({"demo": {
        "tiny": story_record(a, "DSGNConfig.tiny()"),
        "tiny_rerun": {"wall_s": b["wall_s"], "same_metrics_bits": True,
                       "same_weights": True},
        "train": story_record(runs["train"], "DSGNConfig()"),
        "phase_s": time.perf_counter() - t0, "card": card}}))
    return {name: run["launches"] for name, run in runs.items()}


# -------------------------------------------------------------- phase 17

# the Stereo R-CNN story: the driver's schedule at the tiny config (up to
# step index 2,500, probes from 1,250 every 250), the determinism rerun's
# steps, and the full-width story's cap. A full-width fp32 step takes
# about 353 ms on the H100 (a probe about 146 ms, a PGD iteration about
# 265 ms): 250 steps keep phase 17 near 250 s with the tiny story's ~130.
SRCNN_DEMO_STEPS = 2500
SRCNN_RERUN_STEPS = 100
SRCNN_DEMO_CAP = 250


def srcnn_demo_phase(dev, card, steps=SRCNN_DEMO_STEPS,
                     rerun=SRCNN_RERUN_STEPS, cap=SRCNN_DEMO_CAP,
                     capped_scale="train"):
    """17. The Stereo R-CNN full story (examples/srcnn_end_to_end.py),
    fp32 with TF32 off: (a) the tiny story (StereoRCNNConfig.tiny()) on
    the driver's schedule, held to tests/test_srcnn_end_to_end.py's five
    conditions (clean score >= 0.5, clean IoU > 0.3, the attack's last
    loss above its first by 10, every pixel within eps, the attacked
    score below the clean one by 0.1); (b) its first `rerun` steps again
    from a fresh model: every step's loss and the weights' SHA-256 after
    them the same bits; (c) StereoRCNNConfig() on the same recipe, capped
    at `cap` steps, probed at the cap, then attacked: finite losses, the
    loss at the cap below step 0's, the attack ascending within eps (the
    car found or not, its IoU and both scores printed); (d) no port
    kernel launched over the phase. Prints the `srcnn_demo` line and
    returns the phase's launches."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.examples import srcnn_end_to_end as S
    from eval_driving_safety_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    eps = S.ATTACK["eps"]
    _cuda.reset_launches()

    # (a) the tiny story, uncut
    torch.cuda.reset_peak_memory_stats()
    st = {}
    a = S.run("tiny", steps=steps, device=dev.type, stats=st,
              digest_after=rerun, log=log)
    log(json.dumps(a))
    tiny = {**a, "logged_losses": st["logged"], "probes": st["probes"],
            "var_min": st["var_min"], "finite": st["finite"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    check(a["ok"] and a["clean_score"] >= 0.5 and a["clean_iou"] > 0.3
          and a["attack_losses"][-1] > a["attack_losses"][0] + 10.0
          and a["max_delta"] <= eps + 1e-3
          and a["adv_score"] < a["clean_score"] - 0.1,
          f"the tiny Stereo R-CNN story: {a}")

    # (b) its first steps again
    t1 = time.perf_counter()
    scene, model, uncert = S.setup("tiny", 0, dev)
    again = S.overfit(model, uncert, scene, rerun, probe_from=rerun,
                      digest_after=rerun, log=lambda m: None)
    same_losses = np.array_equal(again["losses"], st["losses"][:rerun])
    check(same_losses and again["sha256"] == st["sha256"],
          f"the tiny story's first {rerun} steps differ: losses equal "
          f"{same_losses}, weights {again['sha256']} / {st['sha256']}")
    del scene, model, uncert
    rerun_rec = {"steps": rerun, "same_losses_bits": True,
                 "same_weights": True, "sha256": st["sha256"],
                 "wall_s": time.perf_counter() - t1}

    # (c) full width, capped
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    scene, model, uncert = S.setup(capped_scale, 0, dev)
    tr = S.overfit(model, uncert, scene, cap, probe_from=cap, log=log)
    losses = tr["losses"]
    torch.cuda.synchronize()
    tp = time.perf_counter()
    found = S.hits(S.detections(model, scene, scene.left, scene.right),
                   scene.box)
    probe_ms = 1e3 * (time.perf_counter() - tp)
    best = max(found, key=lambda d: d["score"]) if found else None
    adv = S.attacked(model, uncert, scene)
    var = float(S.frozen_var(model).min())
    capped = {
        "config": "StereoRCNNConfig()" if capped_scale == "train"
        else capped_scale, "cap": cap, "box": scene.box.tolist(),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "logged_losses": tr["logged"], "found": best is not None,
        "clean_score": float(best["score"]) if best else 0.0,
        "clean_iou": float(S.iou(best["bbox"], scene.box)) if best else 0.0,
        "attack_losses": adv["attack_losses"],
        "max_delta": adv["max_delta"], "adv_score": adv["adv_score"],
        "train_ms_per_step": 1e3 * tr["train_s"] / cap, "probe_ms": probe_ms,
        "pgd_ms_per_iter": 1e3 * adv["attack_s"] / S.ATTACK["num_iters"],
        "var_min": var, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "wall_s": time.perf_counter() - t1}
    del scene, model, uncert
    torch.cuda.empty_cache()
    log(f"full width, {cap} steps: the car found {capped['found']}, IoU "
        f"{capped['clean_iou']:.3f}, score {capped['clean_score']:.3f} -> "
        f"attacked {capped['adv_score']:.3f}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0]
          and adv["attack_losses"][-1] > adv["attack_losses"][0]
          and adv["max_delta"] <= eps + 1e-3,
          f"the capped full-width story: {capped}")

    # (d) no port kernel
    launches = dict(_cuda.launches)
    check(not any(launches.values()),
          f"the Stereo R-CNN story launched port kernels: {launches}")
    log(json.dumps({"srcnn_demo": {
        "tiny": tiny, "tiny_rerun": rerun_rec, "capped": capped,
        "launches": launches, "phase_s": time.perf_counter() - t0,
        "card": card}}))
    return launches


# -------------------------------------------------------------- phase 18

# a PGD iteration launches what a patch step does; with remat the fast
# DSGN's hourglass runs its five stride-1 blocks' K3 (0, 2, 4, 5, 6)
# again inside the backward pass, while the compat model's hourglass is
# library convs (K1 and K2 only, remat or not); under a depth objective
# no output of the 3DGV/BEV branch reaches the loss: its three K3 run
# forward, no K4 dx
ATTACK_PER_ITER = PATCH_PER_STEP
REMAT_PER_ITER = {"dsgn": dict(ATTACK_PER_ITER, depth_tap_conv_fwd=13),
                  "compat": COMPAT_PER_ITER}
DEPTH_OBJECTIVE_PER_ITER = dict(ATTACK_PER_ITER, depth_tap_conv_bwd=5)
OPTION_ITERS = 3
DEPTH_SHIFT_M = 5.0


def option_sweep(tmp, dev, name, *flags, iters=OPTION_ITERS,
                 scale="paper"):
    """The attack CLI at --scale paper over phase 4's frames into
    tmp/options/NAME with `flags`, the launch counts set to 0 just
    before it: its directory, seconds, losses, launches, launch shapes
    and nonzero signs."""
    from eval_driving_safety_tpu_torch.ops import _cuda
    out = os.path.join(tmp, "options", name)
    _cuda.reset_launches()
    with recorded_signs(nonzero_signs) as signs:
        t, losses, _ = run_cli([
            "--data_path", os.path.join(tmp, "kitti"), "--detector", "dsgn",
            "--scale", scale, "--iter", str(iters), "--batch", "1",
            "--device", str(dev), "--out_prefix",
            os.path.join(out, "dsgn_pgd"), *flags])
    return {"dir": out, "run_s": t, "losses": losses,
            "launches": dict(_cuda.launches),
            "shapes": {(k, s) for k, s, _ in _cuda.launch_shapes},
            "dtypes": {dt for _, _, dt in _cuda.launch_shapes},
            "signs": signs, "iters": iters}


def sweep_launches_ok(run, per, phase2):
    """A sweep over phase 4's two frames launched `per` an iteration, at
    shapes phase 2 held, in bf16."""
    return launches_are(run["launches"], per, 2 * run["iters"]) and \
        run["shapes"] <= phase2 and run["dtypes"] <= {"bfloat16"}


def iteration_files(run, k):
    """{path: bytes} of a sweep's iteration k."""
    return png_dir_bytes(os.path.join(run["dir"], f"dsgn_pgd_iters_{k}"))


def remat_sweeps(tmp, dev, phase2, scale="paper"):
    """(a) The attack CLI at --scale paper over phase 4's frames with and
    without --remat: the same PNG bytes and losses; the launches an
    iteration REMAT_PER_ITER["dsgn"] and ATTACK_PER_ITER at shapes phase
    2 held."""
    plain = option_sweep(tmp, dev, "plain", scale=scale)
    remat = option_sweep(tmp, dev, "remat", "--remat", scale=scale)
    files = png_dir_bytes(plain["dir"])
    check(len(files) == 2 * 2 * (OPTION_ITERS + 1)
          and png_dir_bytes(remat["dir"]) == files
          and remat["losses"] == plain["losses"],
          f"--remat sweep: {len(files)} files, losses {remat['losses']} vs "
          f"{plain['losses']}, or its PNGs differ from the sweep without it")
    check(sweep_launches_ok(plain, ATTACK_PER_ITER, phase2),
          f"sweep without --remat: launches {plain['launches']}")
    check(sweep_launches_ok(remat, REMAT_PER_ITER["dsgn"], phase2),
          f"--remat sweep: launches {remat['launches']} in "
          f"{2 * OPTION_ITERS} iterations, expected "
          f"{REMAT_PER_ITER['dsgn']} an iteration at phase 2's shapes")
    return plain, remat


def remat_patch(tmp, dev, scale="paper"):
    """(b) The patch CLI at --scale paper, 1 epoch of 2 steps (phase 4's
    two frames, 1 step each) from the same epoch0, with and without
    --remat: the same patch.npy bytes; REMAT_PER_ITER["dsgn"] a step."""
    import shutil
    from eval_driving_safety_tpu_torch.cli.patch_attack import \
        main as patch_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    common = ["--data_path", os.path.join(tmp, "kitti"), "--detector", "dsgn",
              "--scale", scale, "--device", str(dev), "--epochs", "1",
              "--iters", "1"]
    a, b = (os.path.join(tmp, "options", f"patch_{n}")
            for n in ("plain", "remat"))
    t_a, _, _ = run_cli(common + ["--save_dir", a], patch_main)
    shutil.copytree(os.path.join(a, "epoch0"), os.path.join(b, "epoch0"))
    _cuda.reset_launches()
    t_b, _, _ = run_cli(common + ["--save_dir", b, "--remat"], patch_main)
    launches = dict(_cuda.launches)
    rel = os.path.join("epoch1", "patch.npy")
    with open(os.path.join(a, rel), "rb") as fa, \
            open(os.path.join(b, rel), "rb") as fb:
        check(fa.read() == fb.read(), "--remat patch: epoch1/patch.npy "
              "differs from the run without it")
    check(launches_are(launches, REMAT_PER_ITER["dsgn"], 2),
          f"--remat patch launches {launches} in 2 steps")
    return {"run_s": t_a, "remat_run_s": t_b, "steps": 2,
            "remat_launches": launches}


def remat_compat(tmp, dev, scale="paper"):
    """(c) The attack CLI on phase 7's random published-layout .tar (the
    upstream default arch), 1 frame, 2 iterations, with and without
    --remat: the same bytes; K1 and K2 once an iteration, nothing else."""
    from eval_driving_safety_tpu_torch.models.dsgn_compat import \
        DSGNCompatArch
    from eval_driving_safety_tpu_torch.ops import _cuda
    tar = os.path.join(tmp, "finetune_53.tar")
    if not os.path.exists(tar):
        write_compat_tar(tar, scale_cfg(scale), DSGNCompatArch())
    runs = {}
    for name, flags in (("plain", []), ("remat", ["--remat"])):
        out = os.path.join(tmp, "options", f"compat_{name}")
        _cuda.reset_launches()
        t, losses, _ = run_cli([
            "--data_path", os.path.join(tmp, "kitti"), "--detector", "dsgn",
            "--scale", scale, "--device", str(dev), "--ckpt", tar,
            "--iter", "2", "--debug", "--debugnum", "1",
            "--out_prefix", os.path.join(out, "dsgn_pgd"), *flags])
        runs[name] = {"run_s": t, "losses": losses,
                      "launches": dict(_cuda.launches),
                      "files": png_dir_bytes(out)}
        check(launches_are(runs[name]["launches"], REMAT_PER_ITER["compat"],
                           2), f"compat {name} launches "
              f"{runs[name]['launches']}")
    check(len(runs["plain"]["files"]) == 2 * 3
          and runs["remat"]["files"] == runs["plain"]["files"]
          and runs["remat"]["losses"] == runs["plain"]["losses"],
          "compat --remat: its bytes or losses differ from the run without "
          "it")
    return {k: {m: v[m] for m in ("run_s", "losses", "launches")}
            for k, v in runs.items()}


def remat_predict(tmp, dev, scale="paper"):
    """(d) The predict CLI at --scale paper on phase 6's raised-bias
    weights over phase 4's frames, with and without --remat: under
    inference mode the checkpoint is idle, so the same txt bytes, the
    same launches (K1 once, K3 8 times a pair) and no warning the run
    without it does not give."""
    import warnings
    from eval_driving_safety_tpu_torch.cli.predict_and_save import \
        main as predict_main
    from eval_driving_safety_tpu_torch.ops import _cuda
    ckpt = os.path.join(tmp, "raised_bias.pt")
    if not os.path.exists(ckpt):
        raised_bias_weights(scale_cfg(scale), ckpt)
    runs = {}
    for name, flags in (("plain", []), ("remat", ["--remat"])):
        res = os.path.join(tmp, "options", f"pred_{name}")
        _cuda.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t, _, _ = run_cli([
                "--data_path", os.path.join(tmp, "kitti"), "--detector",
                "dsgn", "--scale", scale, "--device", str(dev), "--ckpt",
                ckpt, "--result_dir", res, *flags], predict_main)
        runs[name] = {"run_s": t, "launches": dict(_cuda.launches),
                      "warnings": sorted({f"{w.category.__name__}: "
                                          f"{w.message}" for w in caught}),
                      "txts": png_dir_bytes(os.path.join(res, "data"))}
    plain, remat = runs["plain"], runs["remat"]
    check(len(plain["txts"]) == 2 and remat["txts"] == plain["txts"]
          and any(plain["txts"].values()),
          "predict --remat: its txts differ from the run without it")
    check(predict_launches_ok(remat["launches"], 2)
          and remat["launches"] == plain["launches"],
          f"predict --remat launches {remat['launches']}")
    check(remat["warnings"] == plain["warnings"],
          f"predict --remat warned: {remat['warnings']} (without it: "
          f"{plain['warnings']})")
    return {k: {m: v[m] for m in ("run_s", "launches", "warnings")}
            for k, v in runs.items()}


def depth_objective_sweeps(tmp, dev, phase2, scale="paper"):
    """(f) The attack CLI at --scale paper over phase 4's frames with
    make_depth_gt's maps for them (phase 5's scans, so phase 5's maps),
    under --objective depth_divergence and depth_shift --depth_shift_m 5,
    each twice: every loss finite and the last above the first, nonzero
    signs, the rerun's bytes, DEPTH_OBJECTIVE_PER_ITER an iteration at
    shapes phase 2 held; then depth_divergence without --depth_dir: every
    iteration's frames the clean ones."""
    import numpy as np
    from eval_driving_safety_tpu_torch.cli import make_depth_gt
    data = os.path.join(tmp, "kitti")
    depth = os.path.join(tmp, "options", "depth_gt")
    ids = ["000001", "000002"]
    write_velodyne(data, ids)
    with contextlib.redirect_stdout(io.StringIO()):
        make_depth_gt.main(["--data_path", data, "--out_dir", depth])
    returns = [int((np.load(os.path.join(depth, f + ".npy")) > 0).sum())
               for f in ids]
    check(all(r > 1000 for r in returns), f"depth gt returns {returns}")
    rec = {"depth_gt_returns": returns}
    for objective, flags in (
            ("depth_divergence", []),
            ("depth_shift", ["--depth_shift_m", str(DEPTH_SHIFT_M)])):
        runs = [option_sweep(tmp, dev, f"{objective}_{i}", "--objective",
                             objective, "--depth_dir", depth, *flags,
                             scale=scale)
                for i in range(2)]
        for run in runs:
            check(len(run["losses"]) == 2 and all(
                len(l) == OPTION_ITERS and all(map(math.isfinite, l))
                and l[-1] > l[0] for l in run["losses"]),
                f"{objective}: losses {run['losses']}, not finite and "
                "ascending")
            check(len(run["signs"]) == 2 and all(n > 0 for n, _ in
                                                 run["signs"]),
                  f"{objective}: nonzero signs {run['signs']}")
            check(sweep_launches_ok(run, DEPTH_OBJECTIVE_PER_ITER, phase2),
                  f"{objective}: launches {run['launches']} in "
                  f"{2 * OPTION_ITERS} iterations, expected "
                  f"{DEPTH_OBJECTIVE_PER_ITER} an iteration")
        check(png_dir_bytes(runs[0]["dir"]) == png_dir_bytes(runs[1]["dir"]),
              f"{objective}: a rerun wrote other bytes")
        rec[objective] = {
            "run_s": [r["run_s"] for r in runs], "losses": runs[0]["losses"],
            "nonzero_signs": runs[0]["signs"],
            "launches": runs[0]["launches"]}
    bare = option_sweep(tmp, dev, "no_depth_dir", "--objective",
                        "depth_divergence", iters=2, scale=scale)
    clean = iteration_files(bare, 0)
    check(len(clean) == 4 and all(iteration_files(bare, k) == clean
                                  for k in (1, 2))
          and bare["losses"] == [[0.0, 0.0]] * 2
          and all(n == 0 for n, _ in bare["signs"]),
          f"depth_divergence without --depth_dir: losses {bare['losses']}, "
          "or an iteration's frames differ from the clean ones")
    rec["no_depth_dir"] = {"run_s": bare["run_s"], "losses": bare["losses"],
                           "nonzero_signs": bare["signs"],
                           "launches": bare["launches"]}
    return rec


def tiny_depth_objective_card_vs_cpu(dev, objective):
    """(f) The first step of the tiny DSGN in fp32 under a depth objective
    (seeded maps, half the pixels at 3-50 m) on the card and on the CPU:
    the loss and both image gradients, DEPTH_OBJECTIVE_PER_ITER on the
    card."""
    import numpy as np
    import torch
    from eval_driving_safety_tpu_torch.attack import objectives as O
    from eval_driving_safety_tpu_torch.config import DSGNConfig, replace
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    cfg = replace(DSGNConfig.tiny(), dtype="float32")
    il, ir, calib, _ = tiny_frames()
    rng = np.random.RandomState(4)
    depth = np.where(rng.rand(1, 96, 320) < 0.5,
                     rng.uniform(3.0, 50.0, (1, 96, 320)), 0.0).astype(
        np.float32)
    cpu_model = DSGN(cfg).init_weights(seed=3).requires_grad_(False)
    card_model = DSGN(cfg).requires_grad_(False)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.to(dev)
    mean = np.asarray(cfg.input.mean, np.float32) * 255.0
    std = np.asarray(cfg.input.std, np.float32) * 255.0

    def run(device):
        model = cpu_model if device == "cpu" else card_model
        t = lambda a: torch.as_tensor(a).to(device)
        xl, xr = (t(a).float().requires_grad_(True) for a in (il, ir))
        m, s = t(mean), t(std)
        out = model((xl - m) / s, (xr - m) / s, *(t(c) for c in calib))
        loss = (O.depth_shift(out, t(depth), DEPTH_SHIFT_M, cfg)
                if objective == "depth_shift"
                else O.depth_divergence(out, t(depth), cfg))
        grads = torch.autograd.grad(loss, (xl, xr))
        return float(loss.detach()), [g.cpu() for g in grads]
    card_vs_cpu(f"tiny_{objective}_card_vs_cpu", run,
                DEPTH_OBJECTIVE_PER_ITER, dev)


def debug_nans_sweep(tmp, dev, plain, scale="paper"):
    """(g) One paper-scale iteration under --debug_nans (autograd's
    anomaly mode): the bytes and losses of (a)'s sweep without it at
    iterations 0 and 1; anomaly mode off again afterwards. Returns the
    run's record and the steady-state iteration in anomaly mode."""
    import torch
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    run = option_sweep(tmp, dev, "debug_nans", "--debug_nans", iters=1,
                       scale=scale)
    check(not torch.is_anomaly_enabled(), "--debug_nans left anomaly mode on")
    check(all(iteration_files(run, k) == iteration_files(plain, k)
              for k in (0, 1)) and len(iteration_files(run, 1)) == 4
          and [l[:1] for l in plain["losses"]] == run["losses"],
          f"--debug_nans: losses {run['losses']}, or its PNGs differ from "
          "the sweep without it")
    cfg = scale_cfg(scale)
    model = DSGN(cfg).init_weights(0).to(dev).requires_grad_(False)
    with torch.autograd.set_detect_anomaly(True):
        ss, _ = steady_attack(model, cfg, dev, n=3)
    return {"run_s": run["run_s"], "losses": run["losses"],
            "launches": run["launches"],
            "attack_iter_ms": ss["attack_iter_ms"]}


def remat_steady_state(dev, card):
    """Steady-state attack iteration of the fast DSGN at
    DSGNConfig.full() without and with remat, in turns (plain, remat,
    remat, plain), each with a profile of one iteration (kernel ms, busy
    share) and its peak memory: the `remat_steady_state` line."""
    import torch
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    rec = {"no_remat": [], "remat": []}
    models = {}
    for remat in (False, True, True, False):
        cfg = DSGNConfig.full(remat=remat)
        if remat not in models:
            models[remat] = DSGN(cfg).init_weights(0).to(dev).requires_grad_(
                False)
        torch.cuda.empty_cache()
        ss, attack = steady_attack(models[remat], cfg, dev)
        rows, total_us, port_us = profile_kernels(lambda: attack(1))
        rec["remat" if remat else "no_remat"].append(dict(
            ss, profiled_kernel_ms=total_us / 1e3,
            device_busy_share=(total_us / 1e3) / ss["attack_iter_ms"],
            port_kernel_ms=port_us / 1e3))
    rec["card"] = card
    del models
    torch.cuda.empty_cache()
    log(json.dumps({"remat_steady_state": rec}))


def options_phase(tmp, card, dev, phase2, scale="paper"):
    """18. The CLIs' options that no earlier phase sets, over phase 4's
    frames at --scale paper (--remat on the model axis runs in phase
    15): (a)-(d) --remat in the attack, patch (fast model), attack
    (compat model) and predict CLIs, each writing the bytes of its run
    without it; (f) the depth objectives with --depth_dir, and without
    it, and their tiny fp32 first step on the card and on the CPU; (g)
    --debug_nans. Prints the `remat_steady_state` and `options` lines
    and returns the record of the latter. `scale` "tiny" rehearses the
    phase on the CPU, where no kernel launches (its launch checks fail)
    and --remat, which acts at --scale paper only, changes nothing."""
    import torch
    t0 = time.perf_counter()
    plain, remat = remat_sweeps(tmp, dev, phase2, scale)
    rec = {"card": card, "frames": 2, "iters": OPTION_ITERS,
           "remat_sweep": {
               "run_s": plain["run_s"], "remat_run_s": remat["run_s"],
               "losses": plain["losses"], "launches": plain["launches"],
               "remat_launches": remat["launches"]}}
    rec["remat_patch"] = remat_patch(tmp, dev, scale)
    rec["remat_compat"] = remat_compat(tmp, dev, scale)
    rec["remat_predict"] = remat_predict(tmp, dev, scale)
    torch.cuda.empty_cache()
    rec["depth_objectives"] = depth_objective_sweeps(tmp, dev, phase2,
                                                     scale)
    for objective in ("depth_divergence", "depth_shift"):
        tiny_depth_objective_card_vs_cpu(dev, objective)
    rec["debug_nans"] = debug_nans_sweep(tmp, dev, plain, scale)
    torch.cuda.empty_cache()
    remat_steady_state(dev, card)
    rec["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"options": rec}))
    rec["per_iter"] = {
        "remat": {k: v / (2 * OPTION_ITERS)
                  for k, v in remat["launches"].items()},
        "depth_objective": {
            k: v / (2 * OPTION_ITERS)
            for k, v in rec["depth_objectives"]["depth_shift"][
                "launches"].items()}}
    return rec


def launch_counts(launch_shapes):
    """{(kernel, shape): launches} of a rank's recorded launch shapes."""
    counts = {}
    for k, sh, _, n in launch_shapes:
        counts[(k, tuple(sh))] = counts.get((k, tuple(sh)), 0) + n
    return counts


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
    t_start = time.perf_counter()
    phase_s, clock = {}, [t_start]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - clock[0]
        clock[0] = now

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
    lap("1_build")

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
    # ... and at the model axis's per-rank shapes (phase 15)
    per_ranks = {}
    model_axis_kernels(full, dev, per_ranks)
    # ... and at the tiny config's, which phase 16's tiny story launches
    per_tiny = {}
    tiny = DSGNConfig.tiny()
    check_psv(tiny, tiny.dtype, dev, per_tiny)
    check_depthconv(tiny, tiny.dtype, dev, per_tiny, per_tiny)
    torch.cuda.empty_cache()
    lap("2_kernels")

    # 3. tiny model: card vs CPU
    tiny_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    lap("3_tiny_card_vs_cpu")

    # 4. the slice at paper scale; 6. predict over its attacked frames
    # (in its directory), then the attack's steady state; 7. the patch
    # attack over its frames, and the compat model on a checkpoint in the
    # published layout
    phase2 = {(k, s) for k, s, dt in per if dt == full.dtype}
    fwd_shapes = {(k, s) for k, s in phase2 if k in PREDICT_PER_PAIR}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, shapes, widths, n_iters = the_slice(tmp, card, dev)
        lap("4_attack_cli")
        p_launches = predict_cli(tmp, dev, fwd_shapes)
        predict_patch_modes(tmp, dev)
        decode_ms = decode_card_vs_cpu(tmp, full, dev)
        torch.cuda.empty_cache()
        predict_steady_state(tmp, dev, card, decode_ms)
        torch.cuda.empty_cache()
        lap("6_predict")
        patch_launches, patch_steps = patch_cli(tmp, dev, phase2)
        tiny_patch_card_vs_cpu(dev)
        patch_steady_state(tmp, dev, card)
        torch.cuda.empty_cache()
        compat, tar = compat_clis(tmp, dev)
        tiny_compat_card_vs_cpu(dev)
        torch.cuda.empty_cache()
        compat_steady_state(tar, dev, card)
        torch.cuda.empty_cache()
        lap("7_patch_compat")
        # 8. the Stereo R-CNN attack over the same frames; 9. its predict
        # over the attacked sweep and the clean frames, and its patch
        # attack
        srcnn_launches, srcnn_steady = stereo_rcnn_phase(tmp, dev, card)
        lap("8_srcnn_attack")
        replay_host = replay_host_stages(tmp)
        lap("8_replay")
        sp_launches, sp_pairs, spatch_launches, spatch_steps = \
            srcnn_predict_patch_phase(tmp, dev, card)
        lap("9_srcnn_predict_patch")
        # 10. the scene classifiers over the same frames; 11. Stereo
        # R-CNN training on them and the published checkpoint's layout
        cls_launches, cls_steps = classifier_phase(tmp, dev, card)
        lap("10_classifiers")
        st_launches, st_steps = srcnn_train_phase(tmp, dev, card)
        lap("11_srcnn_train")
        # 12. the safety stage on the earlier phases' detections and
        # classifications, and on a corpus at the reference's size
        safety_phase(tmp, card)
        lap("12_safety")
        # 13. the batch split over two gloo ranks on this card
        split = split_phase(tmp, card, phase2, full.dtype)
        lap("13_split")
        # 14. the JAX trainer's orbax checkpoint: read, attacked, resumed
        orbax_phase(tmp, dev, card)
        lap("14_orbax")
        # 15. the model axis: two gloo ranks on this card split the planes
        model_axis = model_axis_phase(tmp, card, dev, {**per, **per_ranks})
        lap("15_model_axis")
        # 18. the options no earlier phase sets, over phase 4's frames:
        # --remat, the depth objectives with --depth_dir, --debug_nans
        options = options_phase(tmp, card, dev, phase2)
        lap("18_options")
    torch.cuda.empty_cache()
    dsgn_steady = steady_state(full, dev, card)
    lap("4_attack_steady_state")
    log(json.dumps({"replay": replay_record(replay_host, dsgn_steady,
                                            srcnn_steady, card)}))

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
                bound_ms=bound(v, "float32")[0],
                bound_by=bound(v, "float32")[1],
                device_bound_share=bound(v, "float32")[0] / v["device_ms"],
                launches=v["launches_per_iter"])
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
    lap("5_training")
    log(json.dumps({"kernel_detail_train": detail_rows(timed_t, t_counts)}))
    rec_t = per_iteration(timed_t, t_counts, cfg_t.dtype)
    log(json.dumps({"kernels_train_step": {
        k: dict(launches_per_step=r["launches_per_iter"],
                max_abs_err=r["err"], **{m: r[m] for m in TIME_KEYS},
                bound_ms=bound(r, cfg_t.dtype)[0],
                bound_by=bound(r, cfg_t.dtype)[1])
        for k, r in rec_t.items()}}))

    # 16. the DSGN full story: overfit, detect, attack, plan and collide,
    # at the tiny config and the trainer's, launching each kernel at
    # phase 5's counts a training step, phase 4's a PGD iteration and
    # phase 6's a detection
    per_step, per_iter = {}, {}
    for into, by_shape in ((per_step, t_counts), (per_iter, counts)):
        for (k, _), n in by_shape.items():
            into[k] = into.get(k, 0) + n
    demo = demo_phase(dev, card, per_step, per_iter,
                      set(per) | set(timed_t) | set(per_tiny))
    torch.cuda.empty_cache()
    lap("16_demo")

    # 17. the Stereo R-CNN full story: overfit, detect, attack, at the
    # tiny config uncut and at StereoRCNNConfig() capped; no port kernel
    srcnn_demo = srcnn_demo_phase(dev, card)
    torch.cuda.empty_cache()
    lap("17_srcnn_demo")

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
            # phase 8: the Stereo R-CNN attack launches none of them
            "launches_per_srcnn_attack_iter": srcnn_launches[name] / (
                len(SRCNN_IDS) * SRCNN_ITERS * 3),
            # phase 9: nor do its predict and patch attack
            "launches_per_srcnn_predict_pair": sp_launches[name] / sp_pairs,
            "launches_per_srcnn_patch_step":
                spatch_launches[name] / spatch_steps,
            # phase 10: the classifiers' train steps (and their other
            # CLIs); phase 11: Stereo R-CNN training. None of them
            "launches_per_classifier_train_step":
                cls_launches[name] / cls_steps,
            "launches_per_srcnn_train_step": st_launches[name] / st_steps,
            # phase 13: each rank's launches in the split DSGN sweep
            "split_sweep_rank_launches": [
                r[name] for r in split["dsgn_sweep"]["rank_launches"]],
            # phase 15: each model rank's launches in one PGD step of the
            # fast DSGN and of the compat model, the planes split in two
            "model_axis_rank_launches_per_pgd_step": [
                r[name] for r in model_axis["dsgn"]["rank_launches"]],
            "model_axis_compat_rank_launches_per_pgd_step": [
                r[name] for r in model_axis["compat"]["rank_launches"]],
            # phase 15 (e) and 18: the same with remat, the hourglass
            # recomputed in the backward pass; phase 18 (f): under a depth
            # objective
            "model_axis_remat_rank_launches_per_pgd_step": [
                r[name] for r in model_axis["dsgn"]["remat"][
                    "rank_launches"]],
            "launches_per_remat_attack_iter":
                options["per_iter"]["remat"][name],
            "launches_per_depth_objective_attack_iter":
                options["per_iter"]["depth_objective"][name],
            # phase 16: the full story at the tiny config (400 training
            # steps, 8 PGD iterations, 2 detections) and at DSGNConfig()
            "demo_tiny_story_launches": demo["tiny"][name],
            "demo_train_story_launches": demo["train"][name],
            # phase 17: the Stereo R-CNN story launches none of them
            "srcnn_demo_launches": srcnn_demo[name],
            # K1, K2: the access widths (bytes) the sweep launched
            **({"vector_bytes": sorted(wd for k, wd in widths if k == name)}
               if name.startswith("psv") else {}),
            "dtype": dt})
    log(json.dumps({"phase_s": phase_s,
                    "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-run"]:
        sys.exit(rank_run(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["--model-axis"]:
        sys.exit(model_axis_run(*sys.argv[2:5], tiny=sys.argv[5:] == ["tiny"]))
    if sys.argv[1:2] == ["--first-step"]:
        sys.exit(first_step_run(*sys.argv[2:5], tiny=sys.argv[5:] == ["tiny"]))
    sys.exit(main())
