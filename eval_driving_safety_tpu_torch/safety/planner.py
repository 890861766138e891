"""A* motion planner over the KS maneuver automaton.

Counterpart of eval_driving_safety_tpu/safety/planner.py, decision for
decision: the band's primitives hooked to the initial state, A* to the
goal region, the solution as a CommonRoad trajectory (KS model, BMW 320i,
cost SM1, dt 0.1 s). No path, or a path of one state, skips the
scenario.

Cost (SM1) = elapsed time steps; heuristic = straight-line time to the
goal at the band's top speed (admissible), with the goal time pruning.
States are bucketed by `round(x / 0.1)` and kin, so one last-bit
difference in a coordinate would change the search: every expression
keeps the JAX package's f64 arithmetic and order, and children are
pushed in the same order (nodes compare by f alone, so ties pop in heap
order).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eval_driving_safety_tpu_torch.config import PlannerConfig
from eval_driving_safety_tpu_torch.safety.collision import (
    first_collision_arrays, scenario_arrays)
from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    PlanningProblem, Scenario, State, Trajectory)
from eval_driving_safety_tpu_torch.safety.primitives import (
    MotionPrimitive, primitives_for_band, transform_states)
from eval_driving_safety_tpu_torch.safety.vehicle import BMW320I


@dataclass(order=True)
class _Node:
    f: float
    g: int = field(compare=False)          # time steps so far
    x: float = field(compare=False, default=0.0)
    y: float = field(compare=False, default=0.0)
    psi: float = field(compare=False, default=0.0)
    v: float = field(compare=False, default=0.0)
    sa: float = field(compare=False, default=0.0)
    states: tuple = field(compare=False, default=())   # accumulated world states


def _wrap_pi(a: float) -> float:
    return (a + math.pi) % (2 * math.pi) - math.pi


def _in_goal(state_row, goal) -> bool:
    """state_row = (x, y, psi, v, sa); time handled by caller."""
    gx, gy = goal.position.center
    c, s = math.cos(goal.position.orientation), math.sin(goal.position.orientation)
    dx, dy = state_row[0] - gx, state_row[1] - gy
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    if abs(lx) > goal.position.length / 2 or abs(ly) > goal.position.width / 2:
        return False
    # psi accumulates unwrapped over primitives — compare wrapped
    if not (goal.orientation.start <= _wrap_pi(state_row[2])
            <= goal.orientation.end):
        return False
    return goal.velocity.start - 1e-6 <= state_row[3] <= goal.velocity.end + 1e-6


class AStarPlanner:
    def __init__(self, scenario: Scenario, problem: PlanningProblem,
                 primitives: Sequence[MotionPrimitive],
                 cfg: PlannerConfig = PlannerConfig(),
                 vehicle=BMW320I):
        self.scenario = scenario
        self.problem = problem
        self.cfg = cfg
        self.vehicle = vehicle
        self.stat, self.dyn = scenario_arrays(scenario)
        # primitives by (v_start, sa_start)
        self.by_start: Dict[Tuple[float, float], List[MotionPrimitive]] = {}
        self.v_samples = sorted({p.v_start for p in primitives})
        self.sa_samples = sorted({p.sa_start for p in primitives})
        for p in primitives:
            self.by_start.setdefault(
                (round(p.v_start, 4), round(p.sa_start, 4)), []).append(p)
        self.vmax = max(self.v_samples)

    # -- collision ---------------------------------------------------------

    def _segment_collides(self, world_states: np.ndarray, t0: int) -> bool:
        """world_states (K+1, 5) with row 0 = previous endpoint (already
        checked); times t0+1 .. t0+K."""
        k = world_states.shape[0] - 1
        ego = np.empty((k, 6))
        ego[:, 0] = np.arange(t0 + 1, t0 + 1 + k)
        ego[:, 1] = world_states[1:, 0]
        ego[:, 2] = world_states[1:, 1]
        ego[:, 3] = world_states[1:, 2]
        ego[:, 4] = self.vehicle.length
        ego[:, 5] = self.vehicle.width
        return first_collision_arrays(ego, self.stat, self.dyn) >= 0

    # -- search ------------------------------------------------------------

    def _heuristic(self, x, y) -> float:
        gx, gy = self.problem.goal.position.center
        return math.hypot(gx - x, gy - y) / self.vmax / self.scenario.dt

    def _initial_nodes(self) -> List[_Node]:
        """Hook the (v = 0) initial state into the automaton: the nearest
        sampled start velocity and zero steering."""
        init = self.problem.initial_state
        v0 = min(self.v_samples, key=lambda v: abs(v - init.velocity))
        sa0 = min(self.sa_samples, key=abs)
        s0 = (init.position[0], init.position[1], init.orientation, v0, sa0)
        return [_Node(f=self._heuristic(s0[0], s0[1]), g=0, x=s0[0], y=s0[1],
                      psi=s0[2], v=v0, sa=sa0, states=(s0 + (0,),))]

    def plan(self) -> Optional[Trajectory]:
        """The first (time-optimal under SM1) trajectory, or None.

        After a None, `self.stats["exhausted"]` says whether the search
        emptied its open set (with the visited buckets disabled, a
        certificate that no primitive path exists) or stopped at
        `max_expansions`; `self.stats["expansions"]` counts expanded
        nodes."""
        goal = self.problem.goal
        open_heap: List[_Node] = self._initial_nodes()
        heapq.heapify(open_heap)
        visited = set()
        expansions = 0
        self.stats = {"expansions": 0, "exhausted": False}
        bxy, bang, bv = (self.cfg.visited_xy, self.cfg.visited_angle,
                         self.cfg.visited_v)
        while open_heap and expansions < self.cfg.max_expansions:
            node = heapq.heappop(open_heap)
            key = (round(node.x / bxy), round(node.y / bxy),
                   round(node.psi / bang), round(node.v / bv),
                   round(node.sa / bang))
            if key in visited:
                continue
            visited.add(key)
            expansions += 1
            for prim in self.by_start.get(
                    (round(node.v, 4), round(node.sa, 4)), ()):
                world = transform_states(prim.states, node.x, node.y,
                                         node.psi)
                g2 = node.g + prim.num_steps
                if g2 > goal.time.end:
                    continue
                if self._segment_collides(world, node.g):
                    continue
                new_states = node.states + tuple(
                    tuple(world[i]) + (node.g + i,)
                    for i in range(1, world.shape[0]))
                # goal test on every state of the new segment
                for row in new_states[-prim.num_steps:]:
                    if row[5] >= goal.time.start and _in_goal(row, goal):
                        upto = new_states[:new_states.index(row) + 1]
                        self.stats = {"expansions": expansions,
                                      "exhausted": False}
                        return self._to_trajectory(upto)
                end = world[-1]
                child = _Node(
                    f=g2 + self._heuristic(end[0], end[1]), g=g2,
                    x=end[0], y=end[1], psi=end[2],
                    v=prim.v_end, sa=prim.sa_end, states=new_states)
                heapq.heappush(open_heap, child)
        self.stats = {"expansions": expansions,
                      "exhausted": not open_heap}
        return None

    @staticmethod
    def _to_trajectory(states) -> Trajectory:
        out = [State(position=np.array([r[0], r[1]]),
                     orientation=_wrap_pi(r[2]),
                     velocity=r[3], steering_angle=r[4], time_step=int(r[5]))
               for r in states]
        return Trajectory(out[0].time_step, out)


def plan_scenario(scenario: Scenario, is_highway: bool,
                  cfg: PlannerConfig = PlannerConfig(),
                  stats: Optional[dict] = None) -> Optional[Trajectory]:
    """Plan the first planning problem of a scenario; None where the
    search finds no path or a path of one state. `stats`, if given, is
    updated with the search's `expansions` and `exhausted`."""
    if not scenario.planning_problems:
        return None
    prims = primitives_for_band(is_highway, cfg)
    planner = AStarPlanner(scenario, scenario.planning_problems[0], prims,
                           cfg)
    traj = planner.plan()
    if stats is not None:
        stats.update(planner.stats)
    if traj is None or len(traj.states) <= 1:
        return None
    return traj
