"""Build, load and launch the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface and loaded with ctypes; no PyTorch headers are
compiled, so a build takes seconds. Libraries go to `_build/` inside the
package, named by a hash of the sources and flags, so an edited source
is rebuilt at its next use. `build_all()` starts one nvcc per source at
once; otherwise a library is built at the first launch that needs it.

Each launcher returns a CUDA status; `launch` raises on anything but 0.
`query` calls a launcher's size function (a workspace's bytes, a launch's
geometry).
`launches` counts the launches of each kernel, `launch_shapes` the
launches of each (kernel, shape, dtype) and `launch_widths` those of each
(kernel, access width in bytes) where a wrapper picks the width;
`align_copies` counts the copies a wrapper made of an input to meet a
kernel's alignment or layout, per op.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every launcher, per library (all return an int status)
SIGNATURES = {
    "psv_warp": {
        "psv_warp_forward": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P),
        "psv_warp_backward": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P),
    },
    "depth_tap_conv": {
        "dtc_forward": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "dtc_backward_dx": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P),
        "dtc_backward_w": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _P),
        # size queries (no stream; they return the size, not a status)
        "dtc_wgrad_workspace_bytes": (_I, _I, _I, _I, _I, _I),
        "dtc_wgrad_tile": (_I, _I, _I),
        "dtc_f32_geometry": (_I, _I, _I, _I, _I, _I, _I),
    },
}

# launch counts of the kernels on the DSGN attack and training paths
# (`depth_tap_conv_bwd` is the dx kernel, `depth_tap_conv_wgrad` the dW /
# d inv / d off kernel, which only training launches), and the launches
# of each (kernel, shape, dtype name)
launches = {"psv_warp_fwd": 0, "psv_warp_bwd": 0,
            "depth_tap_conv_fwd": 0, "depth_tap_conv_bwd": 0,
            "depth_tap_conv_wgrad": 0}
launch_shapes: collections.Counter = collections.Counter()
launch_widths: collections.Counter = collections.Counter()
align_copies: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()
    launch_widths.clear()
    align_copies.clear()


def count_launch(kernel: str, shape, dtype: torch.dtype,
                 width: int | None = None) -> None:
    """Record one launch of `kernel` at `shape` (and at an access width of
    `width` bytes, where the wrapper chose one); wrappers call this right
    after each `launch` and nowhere else."""
    launches[kernel] += 1
    launch_shapes[(kernel, tuple(int(s) for s in shape),
                   str(dtype).removeprefix("torch."))] += 1
    if width is not None:
        launch_widths[(kernel, int(width))] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for `name` unless its library is built; returns
    (process, tmp_path, final_path) or None."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Build every kernel library that is not built yet, one nvcc per
    source, all running at once."""
    with _lock:
        jobs = [j for j in (_start_build(n) for n in SIGNATURES) if j]
        errors = []
        for job in jobs:
            try:
                _finish_build(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start_build(name)
        if job:
            _finish_build(job)
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.eds_error_string.argtypes = [ctypes.c_int]
        lib.eds_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def launch(name: str, fn: str, *args) -> None:
    """Call launcher `fn` of library `name` on the current stream and
    raise if it reports a status other than 0. Pass tensors as
    `.data_ptr()` ints (or None for a null pointer)."""
    lib = _load(name)
    stream = torch.cuda.current_stream().cuda_stream
    status = getattr(lib, fn)(*args, stream)
    if status != 0:
        msg = lib.eds_error_string(status).decode()
        raise RuntimeError(f"{name}.{fn} failed: status {status} ({msg})")


def query(name: str, fn: str, *args) -> int:
    """The int that query `fn` of library `name` returns for `args`."""
    return getattr(_load(name), fn)(*args)


def check_tensors(op: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous CUDA tensors of one supported dtype."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{op}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{op}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: expected contiguous tensors")
