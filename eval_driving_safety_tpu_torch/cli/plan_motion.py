"""Motion planning: scenario XMLs -> CommonRoad solution XMLs.

Counterpart of `eval_driving_safety_tpu.cli.plan_motion`, with its flags,
printout and layout: A* over the KS primitives of the street (6-8 m/s)
or highway band (11-13, where `<id>.txt` is in `--dyna_obj_folder`),
`solution_KS1:SM1:<id>:2020a.xml` for each scenario it solves, and no
file where it finds no path. Runs on the host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.plan_motion \\
      --input_folder scenarios/pgd4 --output_folder solutions/pgd4 \\
      --dyna_obj_folder kitti_labeled/road_dynamic_label
"""
from __future__ import annotations

import argparse
import os
import time

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    read_scenario, write_solution)
from eval_driving_safety_tpu_torch.safety.planner import plan_scenario


def plan_folder(input_folder, output_folder, dyna_obj_folder=None):
    """Plan every scenario of `input_folder`; one record a scenario: its
    id, the states of its solution (0: none), the seconds from reading it
    to writing its solution, and the search's expansions."""
    records = []
    for name in sorted(n for n in os.listdir(input_folder)
                       if n.endswith(".xml")):
        sid = name.rsplit(".", 1)[0]
        t0 = time.perf_counter()
        scenario = read_scenario(os.path.join(input_folder, name),
                                 lanelets=False)
        is_highway = bool(dyna_obj_folder and os.path.exists(
            os.path.join(dyna_obj_folder, sid + ".txt")))
        stats = {}
        traj = plan_scenario(scenario, is_highway, stats=stats)
        if traj is not None:
            write_solution(output_folder, sid, traj,
                           scenario.planning_problems[0].problem_id)
        records.append({"id": sid,
                        "states": 0 if traj is None else len(traj.states),
                        "s": time.perf_counter() - t0,
                        "expansions": stats.get("expansions", 0)})
        if traj is None:
            log(f"{sid}: no path")
        else:
            log(f"{sid}: {len(traj.states)} states, "
                f"time cost {records[-1]['s']:.2f} s")
    return records


def main(argv=None):
    """Returns `plan_folder`'s records."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--dyna_obj_folder", default=None,
                   help="road-dynamic label folder: presence of <id>.txt "
                        "selects the 11-13 primitive band")
    args = p.parse_args(argv)
    records = plan_folder(args.input_folder, args.output_folder,
                          args.dyna_obj_folder)
    n_solved = sum(r["states"] > 0 for r in records)
    log(f"solved {n_solved}/{len(records)}")
    return records


if __name__ == "__main__":
    main()
