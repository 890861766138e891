"""A scenario, and optionally a solution's ego trajectory, as a PNG.

Counterpart of `eval_driving_safety_tpu.cli.plot_scenario`, with its
flags; drawn in numpy (`safety/plot.py`) on the host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.plot_scenario \\
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
from eval_driving_safety_tpu_torch.safety.plot import plot_scenario


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scenario_path", required=True)
    p.add_argument("--solution_path", default=None,
                   help="overlay this solution's ego trajectory")
    p.add_argument("--output", required=True, help="output PNG path")
    args = p.parse_args(argv)
    scenario = read_scenario(args.scenario_path)
    traj = None
    if args.solution_path:
        _, _, traj = read_solution(args.solution_path)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    plot_scenario(scenario, args.output, trajectory=traj)
    log(f"wrote {args.output}")


if __name__ == "__main__":
    main()
