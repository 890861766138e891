"""Collision checking: the C++ oriented-box core through ctypes.

Counterpart of eval_driving_safety_tpu/safety/collision.py. The ego
trajectory becomes a sequence of BMW 320i boxes, tested against a
(ground-truth) scenario's static boxes at every step and its dynamic
obstacles' boxes at the same time step; over a solution folder the
collisions are counted and `collision.txt` holds their number.

`native/collision.cpp` is built with `g++ -O3 -shared -fPIC`, the JAX
package's flags, at its first use (never at import) into `_build/` by
`utils/native_build.py`, which the sweep's two libraries share: named
by a hash of the source and the command, renamed into place, and a
build or load that fails raises with the reason, with nothing falling
back to another implementation. `first_collision_arrays_plain` is the
same test in numpy, for the tests.
"""
from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    Scenario, Trajectory, read_scenario, read_solution)
from eval_driving_safety_tpu_torch.safety.vehicle import BMW320I
from eval_driving_safety_tpu_torch.utils import native_build

SOURCE = native_build.NATIVE_DIR / "collision.cpp"
BUILD_DIR = native_build.BUILD_DIR
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_P, _I = ctypes.POINTER(ctypes.c_double), ctypes.c_int
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    return native_build.library_path(SOURCE, BUILD_DIR, CXX, CXX_FLAGS)


def native():
    """The collision library, built at the first call; raises if it cannot
    be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = native_build.load(SOURCE, BUILD_DIR, CXX, CXX_FLAGS,
                                    "the collision core")
            lib.obb_intersect.argtypes = (_P, _P)
            lib.obb_intersect.restype = _I
            lib.trajectory_first_collision.argtypes = (_P, _I, _P, _I, _P,
                                                       _I)
            lib.trajectory_first_collision.restype = _I
            _lib = lib
        return _lib


def _rows(a, width: int) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"expected an (n, {width}) array, got {a.shape}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def obb_intersect(a, b) -> bool:
    """Whether boxes a and b (cx, cy, orient, length, width) overlap."""
    a = _rows(np.reshape(a, (1, -1)), 5)
    b = _rows(np.reshape(b, (1, -1)), 5)
    return bool(native().obb_intersect(_ptr(a), _ptr(b)))


def first_collision_arrays(ego: np.ndarray, stat: np.ndarray,
                           dyn: np.ndarray) -> int:
    """Index of the first colliding ego row, or -1.

    ego (T, 6) rows (t, cx, cy, orient, len, wid); stat (M, 5); dyn (N, 6)
    time-stamped. The one entry point of the scenario API and of the
    planner's segment pruning."""
    ego, stat, dyn = _rows(ego, 6), _rows(stat, 5), _rows(dyn, 6)
    return int(native().trajectory_first_collision(
        _ptr(ego), len(ego), _ptr(stat), len(stat), _ptr(dyn), len(dyn)))


# ---------------------------------------------------------------------------
# The plain version (numpy), for the tests
# ---------------------------------------------------------------------------

def obb_overlap_plain(a, b) -> bool:
    """rows: (cx, cy, orient, length, width)."""
    ca, sa = np.cos(a[2]), np.sin(a[2])
    cb, sb = np.cos(b[2]), np.sin(b[2])
    d = np.array([b[0] - a[0], b[1] - a[1]])
    for ax, ay in ((ca, sa), (-sa, ca), (cb, sb), (-sb, cb)):
        dist = abs(d[0] * ax + d[1] * ay)
        ra = (a[3] / 2) * abs(ax * ca + ay * sa) + \
            (a[4] / 2) * abs(-ax * sa + ay * ca)
        rb = (b[3] / 2) * abs(ax * cb + ay * sb) + \
            (b[4] / 2) * abs(-ax * sb + ay * cb)
        if dist > ra + rb:
            return False
    return True


def first_collision_arrays_plain(ego, stat, dyn) -> int:
    for i, e in enumerate(ego):
        for s_row in stat:
            if obb_overlap_plain(e[1:], s_row):
                return i
        for d_row in dyn:
            if d_row[0] == e[0] and obb_overlap_plain(e[1:], d_row[1:]):
                return i
    return -1


# ---------------------------------------------------------------------------
# Scenario API
# ---------------------------------------------------------------------------

def scenario_arrays(scenario: Scenario) -> Tuple[np.ndarray, np.ndarray]:
    """(static (M, 5), dynamic (N, 6)) arrays for the native core.

    Dynamic rows hold the obstacle's initial state (t = 0) and every
    trajectory state.
    """
    stat = []
    for ob in scenario.static_obstacles:
        s = ob.initial_state
        stat.append([s.position[0], s.position[1], s.orientation,
                     ob.shape.length, ob.shape.width])
    dyn = []
    for ob in scenario.dynamic_obstacles:
        for s in [ob.initial_state] + list(ob.trajectory.states):
            dyn.append([float(s.time_step), s.position[0], s.position[1],
                        s.orientation, ob.shape.length, ob.shape.width])
    return (np.asarray(stat, np.float64).reshape(-1, 5),
            np.asarray(dyn, np.float64).reshape(-1, 6))


def ego_array(trajectory: Trajectory, length: float = BMW320I.length,
              width: float = BMW320I.width) -> np.ndarray:
    rows = [[float(s.time_step), s.position[0], s.position[1],
             s.orientation, length, width] for s in trajectory.states]
    return np.asarray(rows, np.float64).reshape(-1, 6)


def first_collision(scenario: Scenario, trajectory: Trajectory,
                    length: float = BMW320I.length,
                    width: float = BMW320I.width) -> int:
    """Index of the first colliding ego state, or -1."""
    ego = ego_array(trajectory, length, width)
    stat, dyn = scenario_arrays(scenario)
    return first_collision_arrays(ego, stat, dyn)


def collides(scenario: Scenario, trajectory: Trajectory, **kw) -> bool:
    return first_collision(scenario, trajectory, **kw) >= 0


def check_solution_folder(gt_scenario_dir: str, solution_dir: str,
                          collision_txt: Optional[str] = None,
                          return_trajectories: bool = False):
    """Pair every solution with its GT scenario by the 6-character id at
    [17:23] of its file name, count the colliding ones, and write their
    number to `collision_txt` if given. A solution without its GT scenario
    raises: counting it as clean would bias every rate."""
    names = sorted(
        f for f in os.listdir(solution_dir)
        if f.startswith("solution") and f.endswith(".xml")) \
        if os.path.isdir(solution_dir) else []
    colliding = []
    trajectories = {}
    for name in names:
        sid = name[17:23]
        scen_path = os.path.join(gt_scenario_dir, sid + ".xml")
        if not os.path.exists(scen_path):
            raise FileNotFoundError(
                f"GT scenario for solution {name!r} not found: {scen_path}")
        scenario = read_scenario(scen_path, lanelets=False)
        _, _, traj = read_solution(os.path.join(solution_dir, name))
        trajectories[name] = traj
        if collides(scenario, traj):
            colliding.append(sid)
    if collision_txt:
        with open(collision_txt, "w") as f:
            f.write(str(len(colliding)))
    if return_trajectories:
        return len(colliding), colliding, trajectories
    return len(colliding), colliding
