"""Sweeps of how the bf16 depth-tap conv kernels split their work.

The tensor-core forward and dx of csrc/depth_tap_conv.cu cut the depth
axis into equal chunks, one block each per 64-pixel tile
(`planes_per_block`). By default this measures, on one CUDA card, the
device time of both kernels at the paper-scale launch shapes
(`DSGNConfig.full()`, batch 1) for each number of planes per block,
beside the launcher's own choice and cuDNN's conv3d and data gradient on
the same inputs. With `--wgrad` it times the weight gradient (the split-K
GEMM and its ordered reduction) instead, at the training shapes
(`DSGNConfig()`) and at the paper shapes, for each number of slices S
(`wgrad_slices`), beside cuDNN's weight gradient and the bound:

    python -m eval_driving_safety_tpu_torch.cli.depthconv_split \
        [--wgrad] [--source depth_tap_conv.cu] [--out F]

The source (by default the package's; `--source` takes another version
of it, to compare two in one run) is built once more, into `_build/`,
with the launcher's split overridable. Planes per block: every split
must give the launcher's output bit for bit, and the launcher's output
must match the plain version within 2^-7 of its largest magnitude.
Slices: every S must match the plain version
(`reference_depth_tap_conv_wgrad`) within 2^-7 of its largest magnitude,
and 20 repeats at the launcher's S must give the same bits. Times are
device times (utils/cuda_timing.py, the mean of 40 launches run back to
back). Prints one JSON line per shape (times in ms).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess

import torch
import torch.nn.functional as F

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.depthconv import (
    reference_depth_tap_conv, reference_depth_tap_conv_wgrad)
from eval_driving_safety_tpu_torch.utils.cuda_timing import device_ms

PLANES = (3, 4, 6, 8, 11, 12, 16, 24, 32, 48, 96)
SLICES = (16, 33, 66, 132, 198, 264, 396, 528, 660, 792, 1056)
PEAK_BYTES, PEAK_BF16_OPS = 3.35e12, 989e12       # H100 SXM
_SPLIT = re.compile(r"const int per = planes_per_block\(([^;]*)\);")
_SLICES = re.compile(r"const int slices = wgrad_slices\(([^;]*)\);")
_P, _I = ctypes.c_void_p, ctypes.c_int


def paper_shapes(c):
    """The (B, D, N, C, F) depth-conv launches of one forward of `c`."""
    d, h, w = c.num_depth_planes, c.height // 4, c.width // 4
    pc, gc = c.psv_channels, c.gv_channels
    half = lambda n: -(-n // 2)
    return [(1, d, h * w, pc, pc),
            (1, half(d), half(h) * half(w), 2 * pc, 2 * pc),
            (1, half(half(d)), half(half(h)) * half(half(w)), 2 * pc, 2 * pc),
            (1, c.num_voxels_z, c.num_voxels_y * c.num_voxels_x, gc, gc)]


def build_sweep_lib(source, wgrad=False):
    """`source` (a depth_tap_conv.cu) with `set_split(n)` forcing n planes
    per block or, with `wgrad`, n slices of the weight gradient (0: the
    launcher's choice)."""
    src = pathlib.Path(source).read_text()
    pattern, forced = (
        (_SLICES, r"const int slices = forced > 0 ? (int)(forced < items ? "
                  r"forced : items) : wgrad_slices(\1);") if wgrad else
        (_SPLIT, r"const int per = forced > 0 ? (forced < D ? forced : D) "
                 r": planes_per_block(\1);"))
    if not pattern.search(src):
        raise RuntimeError(f"depth_tap_conv.cu: no {pattern.pattern}")
    src = pattern.sub(forced, src)
    src = src.replace("namespace {", "namespace {\nint forced = 0;", 1)
    src += '\nextern "C" void set_split(int n) { forced = n; }\n'
    out = _cuda.BUILD_DIR / "split_sweep" / hashlib.sha256(
        src.encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "depth_tap_conv_split.cu", out / "depth_tap_conv_split.so"
    cu.write_text(src)
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I",
                    str(_cuda.CSRC), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("dtc_forward", "dtc_backward_dx"):
        getattr(lib, fn).argtypes = [_I, *[_P] * 5, *[_I] * 6, _P]
    lib.dtc_backward_w.argtypes = [_I, *[_P] * 8, *[_I] * 6, _P]
    lib.set_split.argtypes = [_I]
    return lib


def sweep_shape(lib, shape, dev):
    b, d, n, c, f = shape
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = (torch.randn(b, d, n, c, device=dev, generator=g) * 0.5).to(bf)
    w = (torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5).to(bf)
    inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(bf)
    off = (0.1 * torch.randn(f, device=dev, generator=g)).to(bf)
    dy = torch.randn(b, d, n, f, device=dev, generator=g).to(bf)
    y = torch.empty(b, d, n, f, device=dev, dtype=bf)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        st = lib.dtc_forward(1, x.data_ptr(), w.data_ptr(), inv.data_ptr(),
                             off.data_ptr(), y.data_ptr(), b, d, n, c, f, 1,
                             stream)
        assert st == 0, st

    def bwd():
        st = lib.dtc_backward_dx(1, y_ref.data_ptr(), dy.data_ptr(),
                                 w.data_ptr(), inv.data_ptr(), dx.data_ptr(),
                                 b, d, n, c, f, 1, stream)
        assert st == 0, st

    lib.set_split(0)
    fwd()
    y_ref = y.clone()
    want = reference_depth_tap_conv(x[:, :, :, None], w, inv, off)[:, :, :, 0]
    scale = float(want.float().abs().max())
    err = float((y_ref.float() - want.float()).abs().max())
    if err > 2.0 ** -7 * scale:
        raise SystemExit(f"{shape}: forward off the plain version by {err}")
    bwd()
    dx_ref = dx.clone()
    xc = x[:, :, :, None].permute(0, 4, 1, 2, 3)
    wc = w.permute(2, 1, 0)[..., None, None]
    dyc = dy[:, :, :, None].permute(0, 4, 1, 2, 3)
    rec = {"shape": list(shape),
           "cudnn_fwd": device_ms(lambda: F.conv3d(xc, wc, padding=(1, 0, 0)),
                                 40),
           "cudnn_dgrad": device_ms(
               lambda: torch.ops.aten.convolution_backward(
                   dyc, xc, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1], False,
                   [0, 0, 0], 1, [True, False, False]), 40)}
    for planes in (0, *(p for p in PLANES if p < d)):
        lib.set_split(planes)
        times = [device_ms(fwd, 40), device_ms(bwd, 40)]
        if not (torch.equal(y, y_ref) and torch.equal(dx, dx_ref)):
            raise SystemExit(f"{shape}: {planes} planes per block changed "
                             "the result")
        rec["launcher" if planes == 0 else f"planes_{planes}"] = times
    lib.set_split(0)
    return rec


def kernel_device_us(fn, reps=10):
    """Device time of each of the weight gradient's kernels in one call
    of `fn`, from the profiler (mean over `reps` calls)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"dtc_wgrad_\w+(<\d+>)?", ev.key)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + \
                getattr(ev, "self_device_time_total", 0.0) / reps
    return out


def sweep_wgrad_shape(lib, shape, dev):
    """The bf16 weight gradient at `shape` for the launcher's S and each S
    of SLICES up to the plane-tiles: device ms, errors against the plain
    version; cuDNN's weight gradient and the bound beside them."""
    b, d, n, c, f = shape
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = (torch.randn(b, d, n, c, device=dev, generator=g) * 0.5).to(bf)
    w = (torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5).to(bf)
    inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(bf)
    off = (0.1 * torch.randn(f, device=dev, generator=g)).to(bf)
    dy = torch.randn(b, d, n, f, device=dev, generator=g).to(bf)
    y = reference_depth_tap_conv(x[:, :, :, None], w, inv, off)[:, :, :, 0]
    items = b * -(-n // 64) * d
    slices = [s for s in SLICES if s <= items]
    ws = torch.empty(max(SLICES) * f * (3 * c + 1), device=dev)
    dw = torch.empty(3, c, f, device=dev)
    dco = torch.empty(2, f, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        st = lib.dtc_backward_w(1, x.data_ptr(), y.data_ptr(), dy.data_ptr(),
                                w.data_ptr(), inv.data_ptr(), dw.data_ptr(),
                                dco.data_ptr(), ws.data_ptr(), b, d, n, c, f,
                                1, stream)
        assert st == 0, st

    want = reference_depth_tap_conv_wgrad(x, y, dy, w, inv)

    def errors():
        return [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
                for a, r in zip((dw, dco[0], dco[1]), want)]

    xc = x[:, :, :, None].permute(0, 4, 1, 2, 3)
    wc = w.permute(2, 1, 0)[..., None, None]
    dyc = dy[:, :, :, None].permute(0, 4, 1, 2, 3)
    vol_in, vol_out = b * d * n * c, b * d * n * f
    nbytes = (2 * vol_out + vol_in) * 2 + (3 * c * f + 2 * f) * 2 \
        + (3 * c + 2) * f * 4
    ops = 2 * 3 * c * f * b * d * n
    rec = {"shape": list(shape), "plane_tiles": items,
           "bound_ms": max(nbytes / PEAK_BYTES, ops / PEAK_BF16_OPS) * 1e3,
           "cudnn_wgrad": device_ms(
               lambda: torch.ops.aten.convolution_backward(
                   dyc, xc, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1], False,
                   [0, 0, 0], 1, [False, True, False]), 40)}
    lib.set_split(0)
    run()
    first = (dw.clone(), dco.clone())
    for _ in range(20):
        run()
        if not (torch.equal(dw, first[0]) and torch.equal(dco, first[1])):
            raise SystemExit(f"{shape}: a repeat at the launcher's S gave "
                             "other bits")
    for s in (0, *slices):
        lib.set_split(s)
        run()
        err = errors()
        if max(err) > 2.0 ** -7:
            raise SystemExit(f"{shape}: S={s or 'launcher'} off the plain "
                             f"version by {err} x its largest magnitude")
        rec["launcher" if s == 0 else f"slices_{s}"] = {
            "ms": device_ms(run, 40), "err_dw_dinv_doff": err,
            "kernels_us": kernel_device_us(run)}
    lib.set_split(0)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--source", default=str(_cuda.CSRC / "depth_tap_conv.cu"),
                   help="the depth_tap_conv.cu to build (default: the "
                   "package's)")
    p.add_argument("--wgrad", action="store_true",
                   help="sweep the weight gradient's slices at the training "
                   "and paper shapes")
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = build_sweep_lib(args.source, args.wgrad)
    if args.wgrad:
        cases = [("train", s, sweep_wgrad_shape)
                 for s in paper_shapes(DSGNConfig())]
        cases += [("paper", s, sweep_wgrad_shape)
                  for s in paper_shapes(DSGNConfig.full())]
    else:
        cases = [("paper", s, sweep_shape)
                 for s in paper_shapes(DSGNConfig.full())]
    for config, shape, sweep in cases:
        line = json.dumps({"config": config, **sweep(lib, shape, dev),
                           "source": args.source, "card": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
