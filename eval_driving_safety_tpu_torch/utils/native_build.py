"""Build and load the port's host C++ libraries (`native/*.cpp`).

A library is compiled with g++ at its first use (never at import) into
the package's `_build/`, named by its source's stem and a hash of the
source and the command, under a temporary name that is then renamed into
place, so concurrent builders leave one whole library. A build or load
that fails raises with the reason: nothing falls back to another
implementation. `safety/collision.py`, `attack/replay_native.py` and
`data/png_store.py` load their libraries through `load`.

The sweep's two libraries build with `TUNED_FLAGS`: `-march=native`
lets the compiler vectorize their integer loops with the host's widest
instructions. Such code runs only on a CPU that has those instructions,
so the hash also covers what the compiler resolves `-march=native` to on
the host that loads it: a build directory copied to another CPU builds
anew there instead of loading code that CPU cannot run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR / "_build"
TUNED_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def native_target(cxx: str) -> str:
    """Every target option `cxx -march=native` sets on this host."""
    cmd = [cxx, "-march=native", "-Q", "--help=target"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} could not run ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr}")
    return proc.stdout


def library_path(source: Path, build_dir: Path, cxx: str,
                 flags: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join((cxx, *flags)).encode())
    if "-march=native" in flags:
        h.update(native_target(cxx).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: Path, out: Path, cxx: str, flags: Sequence[str],
          what: str) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp.so")
    cmd = [cxx, *flags, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build {what}: {' '.join(cmd)} could not "
                           f"run ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build {what}: {' '.join(cmd)} exited "
                           f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)


def load(source: Path, build_dir: Path, cxx: str, flags: Sequence[str],
         what: str) -> ctypes.CDLL:
    """The library of `source`, built first if `build_dir` lacks it;
    raises RuntimeError if it cannot be built or loaded."""
    try:
        path = library_path(source, build_dir, cxx, flags)
    except RuntimeError as e:
        raise RuntimeError(f"cannot build {what}: {e}") from e
    if not path.exists():
        build(source, path, cxx, flags, what)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {what} {path}: {e}") from e
