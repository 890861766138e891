"""Collision check of planned solutions against ground-truth scenarios.

Counterpart of `eval_driving_safety_tpu.cli.check_collision`, with its
flags, printout and layout. `--check_all` pairs every solution with its
GT scenario by the 6-character id in its file name, prints the colliding
ids and the collision rate (over every file in the solution folder),
and writes the count to `collision.txt` in the working directory; the
single mode checks one scenario and one solution and `--plot` saves
them as a PNG. Runs on the host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.check_collision --check_all \\
      --scenario_path scenarios/gt/ --solution_path solutions/pgd4/
"""
from __future__ import annotations

import argparse
import os

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.safety.collision import (
    check_solution_folder, collides)
from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    read_scenario, read_solution)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--check_all", action="store_true")
    p.add_argument("--scenario_path", required=True,
                   help="GT scenario folder (batch) or file (single)")
    p.add_argument("--solution_path", required=True)
    p.add_argument("--plot", default=None,
                   help="single mode: save a scenario+trajectory plot here")
    args = p.parse_args(argv)
    if args.check_all:
        n, ids = check_solution_folder(args.scenario_path,
                                       args.solution_path,
                                       collision_txt="collision.txt")
        for i in ids:
            log(i)
        path = args.solution_path
        total = max(len(os.listdir(path)) if os.path.isdir(path) else 1, 1)
        log(f"collision rate: {n / total}")
    else:
        scenario = read_scenario(args.scenario_path,
                                 lanelets=args.plot is not None)
        _, _, traj = read_solution(args.solution_path)
        hit = collides(scenario, traj)
        log(f"Does collision exist?  {hit}")
        if args.plot:
            from eval_driving_safety_tpu_torch.safety.plot import \
                plot_solution
            plot_solution(scenario, traj, args.plot)


if __name__ == "__main__":
    main()
