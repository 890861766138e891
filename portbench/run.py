"""The benchmark of eval_driving_safety_tpu_torch on one H100.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Cells, metrics and bounds are in
BENCHMARK.json; each cell's configuration, traffic, limits and each
per-layer metric are files under portbench/ found by name. Prints, as
its last line of standard output, one JSON object with `correct`,
`attempted`, `failed`, `metrics`, `device` (and with --trace 1
`breakdown`), the numbers that decided `correct` under `checks`, and
before it an `info` line (window, pairs, peak memory, bytes written,
the card's power limit). Exits non-zero with no result when no CUDA
card (or fewer than the cell asks for) is present, when a run fails,
or when jax, jaxlib, flax or the JAX package is loaded once the window
has closed.
"""
import os
import sys
import time


def process_start() -> float:
    """Seconds since this process started, read from /proc; 0 where it
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROC = time.perf_counter() - process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from portbench import harness
    cell = harness.cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.measure(cell, a.seed, a.seconds, bool(a.trace), T_PROC)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} in the measuring process",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    print(json.dumps({"info": result.pop("info")}))
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
