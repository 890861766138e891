"""A scenario and a solution's ego trajectory as a PNG.

Counterpart of `eval_driving_safety_tpu.cli.plot_solution`, with its
flags: `plot_scenario` with the solution required; drawn in numpy on the
host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.plot_solution \\
      --scenario_path scenarios/gt/000123.xml \\
      --solution_path "solutions/pgd4/solution_KS1:SM1:000123:2020a.xml" \\
      --output plots/000123.png
"""
from __future__ import annotations

import argparse
import os

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    read_scenario, read_solution)
from eval_driving_safety_tpu_torch.safety.plot import plot_solution


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scenario_path", required=True)
    p.add_argument("--solution_path", required=True)
    p.add_argument("--output", required=True, help="output PNG path")
    args = p.parse_args(argv)
    scenario = read_scenario(args.scenario_path)
    _, _, traj = read_solution(args.solution_path)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    plot_solution(scenario, traj, args.output)
    log(f"wrote {args.output}")


if __name__ == "__main__":
    main()
