"""The five driving-safety metrics.

Counterpart of eval_driving_safety_tpu/safety/metrics.py, with equal
values:
* successful planning rate = #solutions / #scenarios
* collision rate          = #collisions / #solutions
* safe driving rate       = (#solutions - #collisions) / #scenarios
* average trajectory length (Euclidean sum over solution states) and
* average travel time (0.1 s * last time_step).
Collisions are counted against the ground-truth scenarios while the
solutions were planned on the detected ones.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from eval_driving_safety_tpu_torch.safety.collision import \
    check_solution_folder
from eval_driving_safety_tpu_torch.safety.commonroad_io import read_solution


@dataclass
class SafetyMetrics:
    num_scenarios: int
    num_solutions: int
    num_collisions: int
    success_rate: float
    collision_rate: float
    safe_driving_rate: float
    avg_trajectory_length: float
    avg_travel_time: float
    colliding_ids: List[str]

    def as_dict(self) -> Dict:
        return {
            "num_scenarios": self.num_scenarios,
            "num_solutions": self.num_solutions,
            "num_collisions": self.num_collisions,
            "success_rate": self.success_rate,
            "collision_rate": self.collision_rate,
            "safe_driving_rate": self.safe_driving_rate,
            "avg_trajectory_length": self.avg_trajectory_length,
            "avg_travel_time": self.avg_travel_time,
        }


def trajectory_length(states) -> float:
    """Euclidean arc length over solution states."""
    if len(states) < 2:
        return 0.0
    pts = np.stack([s.position for s in states])
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def travel_time(states, dt: float = 0.1) -> float:
    """dt * last time_step."""
    return dt * states[-1].time_step if states else 0.0


def evaluate_all(scenario_dir: str, solution_dir: str,
                 gt_scenario_dir: Optional[str] = None,
                 dt: float = 0.1) -> SafetyMetrics:
    """All five metrics in one pass; collisions against `gt_scenario_dir`
    (default `scenario_dir`)."""
    scenarios = [f for f in os.listdir(scenario_dir) if f.endswith(".xml")] \
        if os.path.isdir(scenario_dir) else []
    solutions = sorted(
        f for f in os.listdir(solution_dir)
        if f.startswith("solution") and f.endswith(".xml")) \
        if os.path.isdir(solution_dir) else []
    n_scen = len(scenarios)
    n_sol = len(solutions)

    n_coll, colliding, trajectories = check_solution_folder(
        gt_scenario_dir or scenario_dir, solution_dir,
        return_trajectories=True)

    lengths, times = [], []
    for name in solutions:
        traj = trajectories.get(name)
        if traj is None:
            _, _, traj = read_solution(os.path.join(solution_dir, name))
        lengths.append(trajectory_length(traj.states))
        times.append(travel_time(traj.states, dt))

    return SafetyMetrics(
        num_scenarios=n_scen,
        num_solutions=n_sol,
        num_collisions=n_coll,
        success_rate=n_sol / n_scen if n_scen else 0.0,
        collision_rate=n_coll / n_sol if n_sol else 0.0,
        safe_driving_rate=(n_sol - n_coll) / n_scen if n_scen else 0.0,
        avg_trajectory_length=float(np.mean(lengths)) if lengths else 0.0,
        avg_travel_time=float(np.mean(times)) if times else 0.0,
        colliding_ids=colliding,
    )
