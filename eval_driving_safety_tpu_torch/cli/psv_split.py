"""Sweep of the PSV warp kernels' launch choices at the paper's scale.

The forward of csrc/psv_warp.cu (K1) gives each block a run of
`kFwdPlanes` plane rows; the backward (K2) cuts each row into tiles of
pixels (`bwd_tile_pixels`) and keeps a ring of `kStages` planes in flight.
This measures, on one CUDA card, the device time of both kernels at the
paper-scale PSV (`DSGNConfig.full()`, batch 1) for each choice, beside
the launcher's own:

    python -m eval_driving_safety_tpu_torch.cli.psv_split \
        [--dtype bfloat16] [--source psv_warp.cu] [--out F]

The source (by default the package's; `--source` takes another version
of it, to compare two in one run) is built once more per ring depth,
into `_build/`, with the launcher's choices overridable where the
source has them; every choice must give the launcher's output bit for
bit, and the launcher's output must match the plain version (2^-7 of the
largest magnitude in bf16, 1e-5 in fp32). A source whose launchers take
no access width (before the 16-byte kernels) is timed at its launcher's
choice only. Times are
device times of the launcher call alone (utils/cuda_timing.py, the mean
of 40 launches run back to back). Prints one JSON line per ring depth
(times in ms).
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

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.cost_volume import (depth_planes,
                                                           shift_along_width)
from eval_driving_safety_tpu_torch.ops.psv_warp import plane_disparities
from eval_driving_safety_tpu_torch.utils.cuda_timing import device_ms

PLANES = (1, 2, 3, 4, 8, 14)            # K1 plane rows per block
TILES = (16, 32, 39, 52, 64)             # K2 pixels per tile
STAGES = (2, 3, 4, 5, 6, 8)             # K2 ring depths
_STAGES = re.compile(r"constexpr int kStages = \d+;")
# the launchers' choices: name -> (pattern, replacement reading forced[])
_KNOBS = {
    "planes": (re.compile(r"const int per = (kFwdPlanes);"),
               r"const int per = forced[0] > 0 ? forced[0] : \1;"),
    "tile": (re.compile(r"const int tile = (bwd_tile_pixels\(cg\));"),
             r"const int tile = forced[1] > 0 && forced[1] <= kThreads / cg "
             r"? forced[1] : \1;"),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def prepare_build(source, stages):
    """Write `source` with a ring of `stages` planes and `set_choice(
    planes, tile)` forcing the launchers' choices (0: the launcher's own)
    into `_build/`. A source without the access-width argument is left as
    it is. Returns (nvcc command, library path, legacy, knobs present)."""
    src = pathlib.Path(source).read_text()
    legacy = "int vec_bytes" not in src
    knobs = set()
    if not legacy:
        src = _STAGES.sub(f"constexpr int kStages = {stages};", src)
        for name, (pat, rep) in _KNOBS.items():
            if pat.search(src):
                src = pat.sub(rep, src)
                knobs.add(name)
        src = src.replace("namespace {", "namespace {\nint forced[2] = {0, "
                          "0};", 1)
        src += ('\nextern "C" void set_choice(int p, int t) '
                '{ forced[0] = p; forced[1] = t; }\n')
    out = _cuda.BUILD_DIR / "psv_split" / hashlib.sha256(
        src.encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "psv_warp_split.cu", out / "psv_warp_split.so"
    cu.write_text(src)
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
           str(so), str(cu)]
    return cmd, so, legacy, knobs


def load(so, legacy):
    lib = ctypes.CDLL(str(so))
    n = 11 if legacy else 12
    for fn in ("psv_warp_forward", "psv_warp_backward"):
        getattr(lib, fn).argtypes = [_I, *[_P] * 4, *[_I] * (n - 6), _P]
    if not legacy:
        lib.set_choice.argtypes = [_I, _I]
    return lib


def sweep(lib, legacy, knobs, dtype, dev):
    c = DSGNConfig.full()
    h, w, ch, d = c.height // 4, c.width // 4, c.feature_channels, \
        c.num_depth_planes
    g = torch.Generator(device=dev).manual_seed(0)
    fl, fr = (torch.randn(1, h, w, ch, device=dev, generator=g).to(dtype)
              for _ in range(2))
    planes = depth_planes(c.min_depth, c.max_depth, d, device=dev).to(dtype)
    disps = plane_disparities(torch.tensor([721.5377], device=dev).to(dtype),
                              torch.tensor([0.54], device=dev).to(dtype),
                              planes, 4).contiguous()
    out = torch.empty(1, d, h, w, 2 * ch, device=dev, dtype=dtype)
    gout = torch.randn(out.shape, device=dev, generator=g).to(dtype)
    gfr, gfl = torch.empty_like(fr), torch.empty_like(fl)
    code = _cuda.DTYPE_CODES[dtype]
    width = () if legacy else (16,)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        st = lib.psv_warp_forward(code, fr.data_ptr(), fl.data_ptr(),
                                  disps.data_ptr(), out.data_ptr(), 1, d, h,
                                  w, ch, *width, stream)
        assert st == 0, st

    def bwd():
        st = lib.psv_warp_backward(code, gout.data_ptr(), disps.data_ptr(),
                                   gfr.data_ptr(), gfl.data_ptr(), 1, d, h,
                                   w, ch, *width, stream)
        assert st == 0, st

    if not legacy:
        lib.set_choice(0, 0)
    fwd()
    bwd()
    refs = [t.clone() for t in (out, gfr, gfl)]
    want = torch.cat([fl[:, None].expand(-1, d, -1, -1, -1),
                      shift_along_width(fr, disps)], dim=-1)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    err = float((refs[0].float() - want.float()).abs().max())
    if err > rtol * float(want.float().abs().max()):
        raise SystemExit(f"forward off the plain version by {err}")
    rec = {"launcher": [device_ms(fwd, 40), device_ms(bwd, 40)]}
    if legacy:
        return rec
    choices = [(f"planes_{p}", (p, 0)) for p in PLANES
               if "planes" in knobs] + \
        [(f"tile_{t}", (0, t)) for t in TILES if "tile" in knobs]
    for name, choice in choices:
        lib.set_choice(*choice)
        rec[name] = [device_ms(fwd, 40), device_ms(bwd, 40)]
        if not all(torch.equal(a, b) for a, b in zip((out, gfr, gfl), refs)):
            raise SystemExit(f"{name} changed the result")
    lib.set_choice(0, 0)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--source", default=str(_cuda.CSRC / "psv_warp.cu"),
                   help="the psv_warp.cu to build (default: the package's)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dtype = getattr(torch, args.dtype)
    builds = [prepare_build(args.source, n) for n in STAGES]
    procs = {}                          # one nvcc per distinct source
    for cmd, so, _, _ in builds:
        if so not in procs:
            procs[so] = subprocess.Popen(cmd)
    for stages, (_, so, legacy, knobs) in zip(STAGES, builds):
        if procs[so].wait() != 0:
            raise SystemExit(f"nvcc failed on {args.source}")
        lib = load(so, legacy)
        rec = {"stages": None if legacy else stages,
               **sweep(lib, legacy, knobs, dtype, dev), "dtype": args.dtype,
               "source": args.source, "card": card}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if legacy:
            break


if __name__ == "__main__":
    main()
