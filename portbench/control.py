"""Readings that set a cell's limits, in one process (one set-up of the
card and the kernels for all of them):

    python portbench/control.py --workload <cell> --program-seeds a,b,... \\
        --control-seeds x,y,z [--seconds 12] [--control fp8] [--out FILE]

For each program seed, a whole run of the cell with a short window
(`correct` as the limits file stands, and every reading the judge
takes); for each control seed, the control's readings: the plain
reference computed in the precision below the configuration's, put in
the program's place on the same cell's traffic and held to the float32
reference the same way (`--control bf16`: the reference in the
configuration's own precision, a witness where a reading swings). One
JSON line per run (and appended to --out).
"""
import json
import os
import sys
import time

T_PROC = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--control", default="fp8")
    p.add_argument("--control-batches", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    # the control holds a float32 and a float8 copy of the activations
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    from portbench import harness
    from portbench.reference.precision import CASTS
    cell = harness.cell(a.workload)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 3
    judge, adapter = harness.judge_of(cell)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")

    for s in filter(None, a.program_seeds.split(",")):
        t = time.perf_counter()
        r = harness.measure(cell, int(s), a.seconds, False,
                            time.perf_counter())
        emit({"workload": a.workload, "side": "program", "seed": int(s),
              "correct": r["correct"], "checks": r["checks"],
              "readings": r["info"]["readings"],
              "metrics": r["metrics"], "info": r["info"],
              "seconds": time.perf_counter() - t})
    for s in filter(None, a.control_seeds.split(",")):
        t = time.perf_counter()
        got = judge.control(adapter, cell, int(s), "cuda",
                            CASTS[a.control], a.control_batches,
                            cell.traffic["batch"])
        emit({"workload": a.workload, "side": f"control.{a.control}",
              "seed": int(s), "readings": got,
              "seconds": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
