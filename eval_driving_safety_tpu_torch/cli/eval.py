"""The five driving-safety metrics over planned solutions.

Counterpart of `eval_driving_safety_tpu.cli.eval`, with its flags and
printout: successful planning rate, collision rate, safe driving rate,
average trajectory length and average travel time, each with its flag
(none: all), or one JSON line with `--json`. Collisions are checked
against `--gt_scenario_path` while the solutions were planned on the
detected scenarios. Runs on the host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.eval \\
      --scenario_path scenarios/pgd4 --solution_path solutions/pgd4 \\
      --gt_scenario_path scenarios/gt
"""
from __future__ import annotations

import argparse
import json

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.safety.metrics import evaluate_all


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scenario_path", required=True,
                   help="detected-scenario folder (denominator)")
    p.add_argument("--solution_path", required=True)
    p.add_argument("--gt_scenario_path", default=None,
                   help="GT scenarios for collision checking "
                        "(default: scenario_path)")
    p.add_argument("--success_rate", action="store_true")
    p.add_argument("--collision_rate", action="store_true")
    p.add_argument("--safe_driving_rate", action="store_true")
    p.add_argument("--trajectory_length", action="store_true")
    p.add_argument("--travel_time", action="store_true")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    args = p.parse_args(argv)
    m = evaluate_all(args.scenario_path, args.solution_path,
                     args.gt_scenario_path)
    show_all = not any((args.success_rate, args.collision_rate,
                        args.safe_driving_rate, args.trajectory_length,
                        args.travel_time))
    if args.json:
        print(json.dumps(m.as_dict()), flush=True)
        return
    if show_all or args.success_rate:
        log(f"successful planning rate: {m.success_rate:.4f} "
            f"({m.num_solutions}/{m.num_scenarios})")
    if show_all or args.collision_rate:
        log(f"collision rate: {m.collision_rate:.4f} "
            f"({m.num_collisions}/{m.num_solutions})")
    if show_all or args.safe_driving_rate:
        log(f"safe driving rate: {m.safe_driving_rate:.4f}")
    if show_all or args.trajectory_length:
        log(f"average trajectory length: {m.avg_trajectory_length:.4f} m")
    if show_all or args.travel_time:
        log(f"average travel time: {m.avg_travel_time:.4f} s")


if __name__ == "__main__":
    main()
