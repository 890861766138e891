"""Sweeps of how the depth-tap conv kernels split their work.

The tensor-core forward and dx of csrc/depth_tap_conv.cu cut the depth
axis into equal chunks, one block each per 64-pixel tile
(`planes_per_block`). By default this measures, on one CUDA card, the
device time of both kernels at the paper-scale launch shapes
(`DSGNConfig.full()`, batch 1) for each number of planes per block,
beside the launcher's own choice and cuDNN's conv3d and data gradient on
the same inputs. With `--wgrad` it times the weight gradient (the split-K
GEMM and its ordered reduction) instead, in bf16 and in fp32, at the
training shapes (`DSGNConfig()`) and at the paper shapes, for each
number of slices S (`wgrad_slices`, `wgrad_f32_slices`) and, in fp32,
for each pixel tile (`kWgF32TileFloats`), ring depth (`kWgF32Look`) and
warp split (threads a block and blocks an SM, `kWgF32Threads` and
`kWgF32MinBlocks`: the block's warps split the tile's pixels), beside
cuDNN's weight gradient (TF32 off) and the bound. With
`--fp32` it times the fp32 forward and dx (`dtc_f32_kernel`) at the paper
shapes and the tiny config's, for each pixel tile (pixels a thread,
`kF32PixelsPerThread`), ring depth (`kF32Look`), blocks an SM at widths
up to 32 (`kF32MinBlocks`, which caps the registers) and number of
planes per block (the launch's items cut into runs of that many),
beside the
launcher's choice, cuDNN (TF32 off) and the bound:

    python -m eval_driving_safety_tpu_torch.cli.depthconv_split \
        [--wgrad | --fp32] [--source depth_tap_conv.cu] [--out F]

The source (by default the package's; `--source` takes another version
of it, to compare two in one run) is built once more, into `_build/`,
with the launcher's split overridable. Planes per block: every split
must give the launcher's output bit for bit, and the launcher's output
must match the plain version within 2^-7 of its largest magnitude.
Slices: every S (and in fp32 every build) must match the plain version
(`reference_depth_tap_conv_wgrad`) within 2^-7 (fp32: 1e-4) of its
largest magnitude, and 20 repeats at the launcher's choice must give
the same bits; the weight gradient's builds (one nvcc each, all at once)
print their kernels' registers and spill bytes, and `--source` is a
second version timed in turns with the package's (theirs, ours, ours,
theirs), whose bf16 weight gradient must give the package's bits. fp32: the
package's source is swept (one build per pixel tile, ring depth and
blocks an SM, all at once); every choice must match the plain version
within 1e-5 of its largest magnitude and, since none changes an
output's summation order, give the launcher's bits; `--source` is then
a second version whose own
launcher is timed in the same run, in turns with the package's (theirs,
ours, ours, theirs); a first line gives each build's registers and spill
bytes and the card's own f32 FMA rate (`fma_rate`, independent FMA
chains on every SM). Times are device times (utils/cuda_timing.py, the
mean of 40 launches run back to back). Prints one JSON line per shape
(times in ms).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import itertools
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
# fp32: pixels a thread (the pixel tile), planes in flight (the ring),
# blocks an SM the registers leave room for at widths up to 32, and
# planes per block
F32_TILES = (4, 2)
F32_LOOKS = (1, 2)
F32_BLOCKS_SM = (2, 3)
F32_PLANES = (2, 4, 8, 16, 32, 64, 96)
PEAK_F32_OPS = 67e12
SLICES = (16, 33, 66, 132, 198, 264, 396, 528, 660, 792, 1056)
# fp32 weight gradient: the pixel tile's floats, planes in flight, and
# the warp split (threads a block, blocks an SM); slices
WG_F32_TILES = (2048, 4096)
WG_F32_LOOKS = (1, 2)
WG_F32_WARPS = ((128, 2), (128, 3), (256, 1))
WG_F32_SLICES = (66, 132, 198, 264, 396, 528, 792)
PEAK_BYTES, PEAK_BF16_OPS = 3.35e12, 989e12       # H100 SXM
_SPLIT = re.compile(r"const int per = planes_per_block\(([^;]*)\);")
_SLICES = re.compile(r"const int slices = wgrad_slices\(([^;]*)\);")
_WG_F32_SLICES = re.compile(
    r"const int slices = wgrad_f32_slices\(([^;]*)\);")
_WG_F32_KNOBS = {k: re.compile(rf"constexpr int {k} = \d+;")
                 for k in ("kWgF32TileFloats", "kWgF32Look", "kWgF32Threads",
                           "kWgF32MinBlocks")}
_F32_BLOCKS = re.compile(r"\*blocks = f32_blocks\(([^;]*)\);")
_F32_TILE = re.compile(r"constexpr int kF32PixelsPerThread = \d+;")
_F32_LOOK = re.compile(r"constexpr int kF32Look = \d+;")
_F32_BLOCKS_SM = re.compile(r"constexpr int kF32MinBlocks = \d+;")
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


def build_sweep_lib(source):
    """`source` (a depth_tap_conv.cu) with `set_split(n)` forcing n planes
    per block (0: the launcher's choice)."""
    src = pathlib.Path(source).read_text()
    if not _SPLIT.search(src):
        raise RuntimeError(f"depth_tap_conv.cu: no {_SPLIT.pattern}")
    src = _SPLIT.sub(r"const int per = forced > 0 ? (forced < D ? forced : D) "
                     r": planes_per_block(\1);", src)
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
    lib.set_split.argtypes = [_I]
    return lib


def _nvcc_lib(src, tag):
    """The nvcc command that builds source text `src` into
    `_build/split_sweep/` with ptxas's report, and the library's path."""
    out = _cuda.BUILD_DIR / "split_sweep" / hashlib.sha256(
        src.encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{tag}.cu", out / f"{tag}.so"
    cu.write_text(src)
    return [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I",
            str(_cuda.CSRC), "-o", str(so), str(cu)], so


_PTXAS = re.compile(r"Function properties for \S*dtc_f32_kernelILb(\d)ELi(\d+)"
                    r"\S*\s+(\d+) bytes stack frame, (\d+) bytes spill "
                    r"stores.*?\n.*?Used (\d+) registers")


_WG_PTXAS = re.compile(r"Function properties for \S*?(dtc_wgrad_(?:f32|mma|"
                       r"reduce)_kernel)(I\w+?E)?\S*\s+(\d+) bytes stack "
                       r"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) "
                       r"registers")


def wgrad_registers(report):
    """{"dtc_wgrad_f32_kernel": [registers, spill store bytes], ...} of
    the weight gradient's kernels in a ptxas report."""
    return {name + (tpl[1:-1] if tpl else ""): [int(r), int(sp)]
            for name, tpl, _, sp, r in _WG_PTXAS.findall(report)}


def f32_registers(report):
    """{"fwd32": [registers, spill store bytes], ...} of the fp32 kernels
    in a ptxas report."""
    return {f"{'dx' if dx == '1' else 'fwd'}{k}": [int(r), int(sp)]
            for dx, k, _, sp, r in _PTXAS.findall(report)}


def _load_f32(so, split):
    lib = ctypes.CDLL(str(so))
    for fn in ("dtc_forward", "dtc_backward_dx"):
        getattr(lib, fn).argtypes = [_I, *[_P] * 5, *[_I] * 6, _P]
    if split:
        lib.set_split.argtypes = [_I]
        lib.dtc_f32_geometry.argtypes = [_I] * 7
    return lib


# The card's own rate of f32 FMAs on CUDA cores, the yardstick beside the
# 67 TFLOP/s of the data sheet: each thread runs 16 independent FMA
# chains, eight 256-thread blocks an SM.
FMA_RATE_SRC = r"""
extern "C" __global__ void fma_rate(float* out, int iters) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 1e-3f + i;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = fmaf(a[i], 0.999999f, 1e-7f);
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += a[i];
  if (s == 12345.f) out[0] = s;
}
extern "C" int run_fma_rate(float* out, int blocks, int iters, void* st) {
  fma_rate<<<blocks, 256, 0, (cudaStream_t)st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def fma_rate_tflops(lib, dev):
    """TFLOP/s of `lib`'s fma_rate kernel on the device clock."""
    lib.run_fma_rate.argtypes = [_P, _I, _I, _P]
    out = torch.zeros(1, device=dev)
    blocks, iters = 8 * torch.cuda.get_device_properties(
        dev).multi_processor_count, 20000
    stream = torch.cuda.current_stream().cuda_stream
    ms = device_ms(lambda: lib.run_fma_rate(out.data_ptr(), blocks, iters,
                                            stream), 5)
    return 2.0 * 16 * iters * blocks * 256 / ms / 1e9


def _run_nvcc(jobs, parse):
    """Run the nvcc commands of `jobs` ({key: (command, library)}) at
    once; {key: parse(ptxas report)}."""
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (cmd, _) in jobs.items()}
    registers = {}
    for k, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {k}:\n{report}")
        registers["_".join(map(str, k)) if isinstance(k, tuple) else k] = \
            parse(report)
    return registers


def build_wgrad_libs(source):
    """The package's source once per fp32 pixel tile, ring depth and warp
    split (WG_F32_*), each with `set_split(n)` forcing n slices of both
    weight gradients (0: the launcher's), and `source` as it is when it
    is another file; all nvcc runs at once. Returns ({(tile floats, look,
    threads, blocks an SM): lib}, lib of `source` or None, each build's
    weight-gradient kernels' registers and spill bytes, and the key of
    the build with the package's own constants)."""
    text = (_cuda.CSRC / "depth_tap_conv.cu").read_text()
    for pattern in (_SLICES, _WG_F32_SLICES, *_WG_F32_KNOBS.values()):
        if not pattern.search(text):
            raise RuntimeError(f"depth_tap_conv.cu: no {pattern.pattern}")
    base = tuple(int(pattern.search(text).group(0).split()[-1][:-1])
                 for pattern in _WG_F32_KNOBS.values())
    forced = (r"const int slices = forced > 0 ? (int)(forced < items ? "
              r"forced : items) : {}(\1);")
    text = _SLICES.sub(forced.format("wgrad_slices"), text)
    text = _WG_F32_SLICES.sub(forced.format("wgrad_f32_slices"), text)
    text = text.replace("namespace {", "namespace {\nint forced = 0;", 1)
    text += '\nextern "C" void set_split(int n) { forced = n; }\n'
    jobs = {}
    for tile, look, (threads, per_sm) in itertools.product(
            WG_F32_TILES, WG_F32_LOOKS, WG_F32_WARPS):
        src = text
        for name, v in zip(_WG_F32_KNOBS, (tile, look, threads, per_sm)):
            src = _WG_F32_KNOBS[name].sub(f"constexpr int {name} = {v};", src)
        jobs[(tile, look, threads, per_sm)] = _nvcc_lib(
            src, f"wg_t{tile}_l{look}_w{threads}_b{per_sm}")
    if base not in jobs:
        raise SystemExit(f"the package's fp32 weight-gradient constants "
                         f"{base} are not among the swept builds")
    other = pathlib.Path(source).resolve()
    if other != (_cuda.CSRC / "depth_tap_conv.cu").resolve():
        jobs["source"] = _nvcc_lib(other.read_text(), "wg_source")
    registers = _run_nvcc(jobs, wgrad_registers)
    libs = {}
    for k, (_, so) in jobs.items():
        lib = libs[k] = ctypes.CDLL(str(so))
        lib.dtc_backward_w.argtypes = [_I, *[_P] * 8, *[_I] * 6, _P]
        if k != "source":
            lib.set_split.argtypes = [_I]
            lib.dtc_wgrad_tile.argtypes = [_I] * 3
    return libs, libs.pop("source", None), registers, base


def build_f32_libs(source):
    """The package's source once per (pixels a thread, ring depth, blocks
    an SM), with
    `set_split(n)` forcing n planes per block (0: the launcher's), and
    `source` as it is when it is another file; all nvcc runs at once.
    Returns ({(tile, look, blocks an SM): lib}, lib of `source` or None,
    each build's fp32 kernels' registers and spill bytes, and the library
    of the FMA-rate kernel)."""
    text = (_cuda.CSRC / "depth_tap_conv.cu").read_text()
    for pattern in (_F32_BLOCKS, _F32_TILE, _F32_LOOK, _F32_BLOCKS_SM):
        if not pattern.search(text):
            raise RuntimeError(f"depth_tap_conv.cu: no {pattern.pattern}")
    text = _F32_BLOCKS.sub(
        r"*blocks = forced > 0 ? (*items + forced - 1) / forced : "
        r"f32_blocks(\1);", text)
    text = text.replace("namespace {", "namespace {\nint forced = 0;", 1)
    text += '\nextern "C" void set_split(int n) { forced = n; }\n'
    jobs = {}
    for tile, look, per_sm in itertools.product(F32_TILES, F32_LOOKS,
                                                F32_BLOCKS_SM):
        src = _F32_TILE.sub(f"constexpr int kF32PixelsPerThread = {tile};",
                            text)
        src = _F32_LOOK.sub(f"constexpr int kF32Look = {look};", src)
        src = _F32_BLOCKS_SM.sub(f"constexpr int kF32MinBlocks = {per_sm};",
                                 src)
        jobs[(tile, look, per_sm)] = _nvcc_lib(
            src, f"f32_t{tile}_l{look}_b{per_sm}")
    other = pathlib.Path(source).resolve()
    if other != (_cuda.CSRC / "depth_tap_conv.cu").resolve():
        jobs["source"] = _nvcc_lib(other.read_text(), "f32_source")
    jobs["fma_rate"] = _nvcc_lib(FMA_RATE_SRC, "fma_rate")
    registers = _run_nvcc(jobs, f32_registers)
    rate = ctypes.CDLL(str(jobs.pop("fma_rate")[1]))
    registers.pop("fma_rate")
    libs = {k: _load_f32(so, k != "source") for k, (_, so) in jobs.items()}
    return libs, libs.pop("source", None), registers, rate


def sweep_f32_shape(libs, shape, dev, other=None):
    """fp32 forward and dx at `shape` for every build and planes per block
    (and `other`'s launcher, in turns): device ms, errors against the
    plain version, bits against the launcher's; cuDNN and the bound."""
    b, d, n, c, f = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, d, n, c, device=dev, generator=g) * 0.5
    w = torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5
    inv = 1 + 0.2 * torch.randn(f, device=dev, generator=g)
    off = 0.1 * torch.randn(f, device=dev, generator=g)
    dy = torch.randn(b, d, n, f, device=dev, generator=g)
    y_ref = reference_depth_tap_conv(x[:, :, :, None], w, inv,
                                     off)[:, :, :, 0]
    # dx's plain version: the VJP of the linear conv under y_ref's mask
    xp = x.clone().requires_grad_(True)
    lin = reference_depth_tap_conv(xp[:, :, :, None], w, inv, off,
                                   relu=False)[:, :, :, 0]
    (dx_ref,) = torch.autograd.grad(lin, xp, dy * (y_ref > 0))
    del lin, xp
    y = torch.empty_like(y_ref)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def calls(lib):
        def fwd():
            st = lib.dtc_forward(0, x.data_ptr(), w.data_ptr(),
                                 inv.data_ptr(), off.data_ptr(), y.data_ptr(),
                                 b, d, n, c, f, 1, stream)
            assert st == 0, st

        def bwd():
            st = lib.dtc_backward_dx(0, y_ref.data_ptr(), dy.data_ptr(),
                                     w.data_ptr(), inv.data_ptr(),
                                     dx.data_ptr(), b, d, n, c, f, 1, stream)
            assert st == 0, st
        return fwd, bwd

    def errors():
        return [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
                for a, r in ((y, y_ref), (dx, dx_ref))]

    xc = x[:, :, :, None].permute(0, 4, 1, 2, 3)
    wc = w.permute(2, 1, 0)[..., None, None]
    dyc = dy[:, :, :, None].permute(0, 4, 1, 2, 3)
    vol_in, vol_out = b * d * n * c, b * d * n * f
    small = (3 * c * f + 2 * f) * 4
    ops = 2 * 3 * c * f * b * d * n
    bound = lambda nbytes: max(nbytes / PEAK_BYTES, ops / PEAK_F32_OPS) * 1e3
    rec = {"shape": list(shape),
           "bound_ms": [bound((vol_in + vol_out) * 4 + small),
                        bound((2 * vol_out + vol_in) * 4 + small)],
           "cudnn": [device_ms(lambda: F.conv3d(xc, wc, padding=(1, 0, 0)),
                               40),
                     device_ms(lambda: torch.ops.aten.convolution_backward(
                         dyc, xc, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1],
                         False, [0, 0, 0], 1, [True, False, False]), 40)]}
    base = libs[(F32_TILES[0], F32_LOOKS[0], F32_BLOCKS_SM[0])]
    base.set_split(0)
    fwd, bwd = calls(base)
    fwd()
    bwd()
    want = (y.clone(), dx.clone())
    err = errors()
    if max(err) > 1e-5:
        raise SystemExit(f"{shape}: launcher off the plain version by {err} "
                         "x its largest magnitude")
    rec["launcher_err_fwd_dx"] = err
    if other is not None:
        ofwd, obwd = calls(other)
        turns = []
        for lib_fns in ((ofwd, obwd), (fwd, bwd), (fwd, bwd), (ofwd, obwd)):
            turns.append([device_ms(fn, 40) for fn in lib_fns])
        rec["source_launcher"] = [(turns[0][k] + turns[3][k]) / 2
                                  for k in range(2)]
        rec["launcher_in_turns"] = [(turns[1][k] + turns[2][k]) / 2
                                    for k in range(2)]
        rec["source_err_fwd_dx"] = errors()
    choices = {}
    for (tile, look, per_sm), lib in libs.items():
        fwd, bwd = calls(lib)
        name = f"tile{tile}_look{look}_sm{per_sm}"
        # the launcher's pixel tile and blocks, forward and dx
        choices[f"{name}_geometry"] = [
            lib.dtc_f32_geometry(what, dx_, b, d, n, c, f)
            for dx_ in (0, 1) for what in (0, 1)]
        for planes in (0, *F32_PLANES):
            lib.set_split(planes)
            times = [device_ms(fwd, 40), device_ms(bwd, 40)]
            if not (torch.equal(y, want[0]) and torch.equal(dx, want[1])):
                raise SystemExit(
                    f"{shape}: {name}, {planes} planes per block changed "
                    f"the result (errors {errors()})")
            key = f"{name}_" + (
                "launcher" if planes == 0 else f"planes_{planes}")
            choices[key] = times
        lib.set_split(0)
    rec["choices"] = choices
    return rec


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


def _wgrad_inputs(shape, dt, dev):
    """Seeded inputs of the weight gradient at `shape` in dtype `dt`,
    with y from the plain forward."""
    b, d, n, c, f = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(b, d, n, c, device=dev, generator=g) * 0.5).to(dt)
    w = (torch.randn(3, c, f, device=dev, generator=g) / c ** 0.5).to(dt)
    inv = (1 + 0.2 * torch.randn(f, device=dev, generator=g)).to(dt)
    off = (0.1 * torch.randn(f, device=dev, generator=g)).to(dt)
    dy = torch.randn(b, d, n, f, device=dev, generator=g).to(dt)
    y = reference_depth_tap_conv(x[:, :, :, None], w, inv, off)[:, :, :, 0]
    return x, w, inv, y, dy


class _Wgrad:
    """The weight gradient of one library at one shape, into shared
    outputs; `errors()` against the plain version, `outputs()` a copy."""

    def __init__(self, shape, dt, dev):
        b, d, n, c, f = shape
        self.shape, self.code = shape, _cuda.DTYPE_CODES[dt]
        self.x, self.w, self.inv, self.y, self.dy = _wgrad_inputs(
            shape, dt, dev)
        self.want = reference_depth_tap_conv_wgrad(self.x, self.y, self.dy,
                                                   self.w, self.inv)
        most = max(*SLICES, *WG_F32_SLICES)
        self.ws = torch.empty(most * f * (3 * c + 1), device=dev)
        self.dw = torch.empty(3, c, f, device=dev)
        self.dco = torch.empty(2, f, device=dev)
        self.stream = torch.cuda.current_stream().cuda_stream

    def call(self, lib):
        def run():
            st = lib.dtc_backward_w(
                self.code, self.x.data_ptr(), self.y.data_ptr(),
                self.dy.data_ptr(), self.w.data_ptr(), self.inv.data_ptr(),
                self.dw.data_ptr(), self.dco.data_ptr(), self.ws.data_ptr(),
                *self.shape, 1, self.stream)
            assert st == 0, st
        return run

    def outputs(self):
        return self.dw.clone(), self.dco.clone()

    def same(self, outs):
        return torch.equal(self.dw, outs[0]) and torch.equal(self.dco,
                                                             outs[1])

    def errors(self):
        return [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
                for a, r in zip((self.dw, self.dco[0], self.dco[1]),
                                self.want)]

    def record(self, peak_ops, isz):
        """The shape, the bound at `peak_ops` with `isz`-byte inputs, and
        cuDNN's weight gradient on the same inputs."""
        b, d, n, c, f = self.shape
        xc = self.x[:, :, :, None].permute(0, 4, 1, 2, 3)
        wc = self.w.permute(2, 1, 0)[..., None, None]
        dyc = self.dy[:, :, :, None].permute(0, 4, 1, 2, 3)
        vol_in, vol_out = b * d * n * c, b * d * n * f
        nbytes = (2 * vol_out + vol_in) * isz + (3 * c * f + 2 * f) * isz \
            + (3 * c + 2) * f * 4
        ops = 2 * 3 * c * f * b * d * n
        return {"shape": list(self.shape),
                "bound_ms": max(nbytes / PEAK_BYTES, ops / peak_ops) * 1e3,
                "cudnn_wgrad": device_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        dyc, xc, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1],
                        False, [0, 0, 0], 1, [False, True, False]), 40)}


def _repeats_same(wg, run, what):
    run()
    first = wg.outputs()
    for _ in range(20):
        run()
        if not wg.same(first):
            raise SystemExit(f"{wg.shape}: a repeat {what} gave other bits")
    return first


def _in_turns(wg, ours, theirs):
    """Device ms of `theirs` and `ours` timed theirs, ours, ours, theirs:
    (theirs, ours), each the mean of its two turns."""
    t = [device_ms(fn, 40) for fn in (theirs, ours, ours, theirs)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def sweep_wgrad_shape(libs, shape, dev, base, other=None):
    """The bf16 weight gradient at `shape` for the launcher's S and each S
    of SLICES up to the plane-tiles: device ms, errors against the plain
    version; cuDNN's weight gradient and the bound beside them; `other`'s
    launcher in turns, which must give the launcher's bits."""
    b, d, n, c, f = shape
    lib = libs[base]
    wg = _Wgrad(shape, torch.bfloat16, dev)
    run = wg.call(lib)
    items = b * -(-n // 64) * d
    rec = {"dtype": "bfloat16", **wg.record(PEAK_BF16_OPS, 2),
           "plane_tiles": items}
    lib.set_split(0)
    first = _repeats_same(wg, run, "at the launcher's S")
    if other is not None:
        wg.call(other)()
        if not wg.same(first):
            raise SystemExit(f"{shape}: --source's bf16 weight gradient "
                             "gave other bits than the package's")
        rec["source_launcher"], rec["launcher_in_turns"] = _in_turns(
            wg, run, wg.call(other))
        rec["source_bits_equal"] = True
    for s in (0, *(s for s in SLICES if s <= items)):
        lib.set_split(s)
        run()
        err = wg.errors()
        if max(err) > 2.0 ** -7:
            raise SystemExit(f"{shape}: S={s or 'launcher'} off the plain "
                             f"version by {err} x its largest magnitude")
        rec["launcher" if s == 0 else f"slices_{s}"] = {
            "ms": device_ms(run, 40), "err_dw_dinv_doff": err,
            "kernels_us": kernel_device_us(run)}
    lib.set_split(0)
    return rec


def sweep_wgrad_f32_shape(libs, shape, dev, base, other=None):
    """The fp32 weight gradient at `shape` for every build (pixel tile,
    ring depth, warp split) and, in each, the launcher's S and each S of
    WG_F32_SLICES up to the plane-tiles: device ms and errors against the
    plain version (1e-4 of its largest magnitude), the launcher's build
    bit for bit over 20 repeats, each build's kernel times at its
    launcher's S; cuDNN's weight gradient and the bound beside them;
    `other`'s launcher in turns."""
    b, d, n, c, f = shape
    wg = _Wgrad(shape, torch.float32, dev)
    rec = {"dtype": "float32", **wg.record(PEAK_F32_OPS, 4)}
    run = wg.call(libs[base])
    libs[base].set_split(0)
    _repeats_same(wg, run, "of the launcher")
    rec["launcher_err_dw_dinv_doff"] = wg.errors()
    if other is not None:
        rec["source_launcher"], rec["launcher_in_turns"] = _in_turns(
            wg, run, wg.call(other))
        wg.call(other)()
        rec["source_err_dw_dinv_doff"] = wg.errors()
    choices = {}
    for key, lib in libs.items():
        name = "tile{}_look{}_threads{}_sm{}".format(*key)
        run = wg.call(lib)
        items = b * -(-n // lib.dtc_wgrad_tile(0, c, f)) * d
        for s in (0, *(s for s in WG_F32_SLICES if s <= items)):
            lib.set_split(s)
            run()
            err = wg.errors()
            if max(err) > 1e-4:
                raise SystemExit(f"{shape}: {name}, S={s or 'launcher'} off "
                                 f"the plain version by {err} x its largest "
                                 "magnitude")
            choices[f"{name}_" + ("launcher" if s == 0 else f"slices_{s}")] \
                = device_ms(run, 40)
            if s == 0:
                choices[f"{name}_kernels_us"] = kernel_device_us(run)
                choices[f"{name}_plane_tiles"] = items
        lib.set_split(0)
    rec["choices"] = choices
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--source", default=str(_cuda.CSRC / "depth_tap_conv.cu"),
                   help="the depth_tap_conv.cu to build (default: the "
                   "package's)")
    p.add_argument("--wgrad", action="store_true",
                   help="sweep the weight gradient (bf16 and fp32) at the "
                   "training and paper shapes; --source is then timed "
                   "beside the package's")
    p.add_argument("--fp32", action="store_true",
                   help="sweep the fp32 forward and dx at the paper and tiny "
                   "shapes; --source is then timed beside the package's")
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    if args.wgrad and args.fp32:
        p.error("--wgrad and --fp32 are two sweeps: pick one")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.fp32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        lib, other, registers, rate = build_f32_libs(args.source)
        line = json.dumps({"registers_and_spill_bytes": registers,
                           "fma_rate_tflops": fma_rate_tflops(rate, dev),
                           "card": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        sweep = functools.partial(sweep_f32_shape, other=other)
        cases = [("paper", s, sweep) for s in paper_shapes(DSGNConfig.full())]
        cases += [("tiny", s, sweep) for s in paper_shapes(DSGNConfig.tiny())]
    elif args.wgrad:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        lib, other, registers, base = build_wgrad_libs(args.source)
        line = json.dumps({"wgrad_registers_and_spill_bytes": registers,
                           "launcher_build": "_".join(map(str, base)),
                           "card": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        cases = []
        for sweep in (sweep_wgrad_shape, sweep_wgrad_f32_shape):
            sweep = functools.partial(sweep, base=base, other=other)
            cases += [("train", s, sweep) for s in paper_shapes(DSGNConfig())]
            cases += [("paper", s, sweep)
                      for s in paper_shapes(DSGNConfig.full())]
    else:
        lib = build_sweep_lib(args.source)
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
