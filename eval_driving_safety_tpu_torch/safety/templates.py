"""The six initial scenarios that every converted scenario starts from.

Counterpart of eval_driving_safety_tpu/safety/templates.py: a straight
road of 27 lanelets 3.5 m wide (y in [-47.25, 47.25], x from -10 to
189 at 1 m, 200 points a bound), planning problem 100 with the ego at
(0, 0) and v = 0, and a 5 x 3.5 m goal rectangle at x = 15 with y = 0
(straight), +3.5 (left) or -3.5 (right), t in [4, 30], orientation in
[-0.5, 0.5] and velocity in [6, 8] (street) or [11, 13] (highway).
`write_templates` writes all six as left|right|straight/
initial_scenario_{6_8,11_13}.xml.
"""
from __future__ import annotations

import os

import numpy as np

from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    GoalState, Interval, Lanelet, PlanningProblem, RectShape, Scenario,
    State, write_scenario)

LANE_WIDTH = 3.5
ROAD_Y_HALF = 47.25                    # outermost bounds: 27 x 3.5 m lanes
ROAD_X = (-10.0, 189.0)
GOAL_Y = {"straight": 0.0, "left": LANE_WIDTH, "right": -LANE_WIDTH}
V_BANDS = {"6_8": (6.0, 8.0), "11_13": (11.0, 13.0)}


def make_road_lanelets() -> list:
    """Parallel straight lanelets covering y in [-47.25, 47.25]."""
    xs = np.arange(ROAD_X[0], ROAD_X[1] + 0.5, 1.0)
    n_lanes = int(round(2 * ROAD_Y_HALF / LANE_WIDTH))
    lanelets = []
    for i in range(n_lanes):
        y_lo = -ROAD_Y_HALF + i * LANE_WIDTH
        y_hi = y_lo + LANE_WIDTH
        left = np.stack([xs, np.full_like(xs, y_hi)], axis=1)
        right = np.stack([xs, np.full_like(xs, y_lo)], axis=1)
        lanelets.append(Lanelet(
            lanelet_id=i + 1, left_bound=left, right_bound=right,
            lanelet_type="urban",
            adjacent_left=(i + 2, "same") if i + 1 < n_lanes else None,
            adjacent_right=(i, "same") if i > 0 else None,
        ))
    return lanelets


def make_init_scenario(direction: str = "straight", v_band: str = "6_8",
                       benchmark_id: str = "ZAM_Tutorial-1_1_T-1") -> Scenario:
    vmin, vmax = V_BANDS[v_band]
    sc = Scenario(benchmark_id=benchmark_id, dt=0.1,
                  lanelets=make_road_lanelets())
    sc.planning_problems.append(PlanningProblem(
        problem_id=100,
        initial_state=State(position=np.zeros(2), orientation=0.0,
                            time_step=0, velocity=0.0, yaw_rate=0.0,
                            slip_angle=0.0),
        goal=GoalState(
            position=RectShape(length=5.0, width=3.5, orientation=0.0,
                               center=(15.0, GOAL_Y[direction])),
            orientation=Interval(-0.5, 0.5),
            time=Interval(4, 30),
            velocity=Interval(vmin, vmax),
        ),
    ))
    return sc


def write_templates(out_dir: str) -> list:
    """All six templates, in the folder layout above."""
    paths = []
    for direction in ("left", "right", "straight"):
        for band in ("6_8", "11_13"):
            sc = make_init_scenario(direction, band)
            p = os.path.join(out_dir, direction,
                             f"initial_scenario_{band}.xml")
            write_scenario(sc, p)
            paths.append(p)
    return paths
