"""KITTI labels -> CommonRoad scenarios.

Counterpart of eval_driving_safety_tpu/safety/convert.py; the same
scenario XMLs byte for byte.
* Detections: every Car, Van, Truck and Misc, whatever its score, becomes
  a static parked vehicle; the template's band is the highway's where the
  frame's label file is in the road-dynamic label folder.
* Ground truth: three classes of frames, static_label (all static),
  dynamic_label + dynamic_annotation (street band) and road_dynamic_label
  + road_dynamic_annotation (highway band), with one code per label line:
  'n' drops the line, '0' makes it static, '1' or '-1' dynamic. A dynamic
  obstacle rolls out 19 steps at a constant speed drawn from
  `np.random.RandomState(seed)` in the band, heading its orientation +
  pi. The folder driver seeds frame i of the three classes with seed + i,
  seed + 1000 + i and seed + 2000 + i, so the ground truth is the JAX
  package's.

KITTI camera frame -> CommonRoad ego plane: position (z, -x),
orientation -(ry - pi/2) wrapped to [-pi, pi], in f64 with the JAX
package's order of operations.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np

from eval_driving_safety_tpu_torch.config import ScenarioConfig
from eval_driving_safety_tpu_torch.data.kitti import KittiObject, read_label
from eval_driving_safety_tpu_torch.safety.commonroad_io import (
    DynamicObstacle, RectShape, Scenario, State, StaticObstacle, Trajectory,
    write_scenario)
from eval_driving_safety_tpu_torch.safety.templates import make_init_scenario


def wrap_pi(a: float) -> float:
    while a < -math.pi:
        a += 2 * math.pi
    while a > math.pi:
        a -= 2 * math.pi
    return a


def camera_to_ego(obj: KittiObject):
    """(position (2,), orientation) in the CommonRoad ego plane."""
    x, _, z = obj.location
    return np.array([z, -x]), wrap_pi(-(obj.rotation_y - 0.5 * math.pi))


def static_obstacle_from(obj: KittiObject, scenario: Scenario) -> StaticObstacle:
    pos, orient = camera_to_ego(obj)
    _, w, l = obj.dimensions
    return StaticObstacle(
        obstacle_id=scenario.generate_object_id(),
        obstacle_type="parkedVehicle",
        shape=RectShape(length=l, width=w),
        initial_state=State(position=pos, orientation=orient, time_step=0),
    )


def dynamic_obstacle_from(obj: KittiObject, scenario: Scenario, vmin: float,
                          vmax: float, rng: np.random.RandomState,
                          steps: int = 19) -> DynamicObstacle:
    pos, orient = camera_to_ego(obj)
    _, w, l = obj.dimensions
    v = float(rng.uniform(vmin, vmax))
    # the obstacle moves along its orientation + pi (mod 2 pi)
    heading = (orient + math.pi) % (2 * math.pi)
    states = []
    for j in range(1, steps + 1):
        p = pos + v * scenario.dt * j * np.array(
            [math.cos(heading), math.sin(heading)])
        states.append(State(position=p, orientation=orient, velocity=v,
                            time_step=j))
    return DynamicObstacle(
        obstacle_id=scenario.generate_object_id(),
        obstacle_type="car",
        shape=RectShape(length=l, width=w),
        initial_state=State(position=pos, orientation=orient, velocity=v,
                            time_step=0),
        trajectory=Trajectory(1, states),
    )


def convert_detection_scenario(objects: Sequence[KittiObject],
                               is_highway: bool,
                               direction: str = "straight",
                               cfg: ScenarioConfig = ScenarioConfig()) -> Scenario:
    """Detections -> an all-static scenario (the planner's worst case)."""
    band = "11_13" if is_highway else "6_8"
    sc = make_init_scenario(direction, band)
    for o in objects:
        if o.type not in cfg.obstacle_classes:
            continue
        sc.static_obstacles.append(static_obstacle_from(o, sc))
    return sc


def convert_gt_scenario(objects: Sequence[KittiObject],
                        annotations: Optional[Sequence[str]],
                        is_highway: bool, direction: str = "straight",
                        cfg: ScenarioConfig = ScenarioConfig(),
                        seed: int = 0) -> Scenario:
    """GT labels and their per-line motion codes -> a mixed scenario.

    `annotations[i]` is the code of label line i, counting every line
    (non-vehicle classes included); None makes every vehicle static.
    """
    band = "11_13" if is_highway else "6_8"
    vmin, vmax = ((cfg.highway_vmin, cfg.highway_vmax) if is_highway
                  else (cfg.street_vmin, cfg.street_vmax))
    rng = np.random.RandomState(seed)
    sc = make_init_scenario(direction, band)
    for i, o in enumerate(objects):
        if o.type not in cfg.obstacle_classes:
            continue
        code = annotations[i].strip() if annotations is not None else "0"
        if code == "n":
            continue
        if code == "0":
            sc.static_obstacles.append(static_obstacle_from(o, sc))
        elif code in ("1", "-1"):
            sc.dynamic_obstacles.append(dynamic_obstacle_from(
                o, sc, vmin, vmax, rng, cfg.dynamic_rollout_steps))
    return sc


# ---------------------------------------------------------------------------
# Folder drivers
# ---------------------------------------------------------------------------

def convert_detection_folder(label_dir: str, out_dir: str,
                             road_dynamic_label_dir: Optional[str] = None,
                             direction: str = "straight",
                             cfg: ScenarioConfig = ScenarioConfig()) -> List[str]:
    """Each label txt -> a scenario XML named <id>.xml, in the highway
    band where the same file name exists in `road_dynamic_label_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(label_dir)):
        if not name.endswith(".txt"):
            continue
        objs = read_label(os.path.join(label_dir, name))
        is_highway = bool(
            road_dynamic_label_dir
            and os.path.exists(os.path.join(road_dynamic_label_dir, name)))
        sc = convert_detection_scenario(objs, is_highway, direction, cfg)
        stem = name.rsplit(".", 1)[0]
        sc.benchmark_id = stem
        path = os.path.join(out_dir, stem + ".xml")
        write_scenario(sc, path)
        written.append(path)
    return written


def _annotations(path: str) -> Optional[List[str]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().splitlines()


def convert_gt_folder(kitti_labeled_dir: str, out_dir: str,
                      direction: str = "straight",
                      cfg: ScenarioConfig = ScenarioConfig(),
                      seed: int = 0) -> List[str]:
    """The three classes of GT frames of a `kitti_labeled/` tree ->
    scenario XMLs named <id>.xml."""
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def labels_in(sub):
        d = os.path.join(kitti_labeled_dir, sub)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    for sub, anno_sub, is_highway, base in (
            ("static_label", None, False, 0),
            ("dynamic_label", "dynamic_annotation", False, 1000),
            ("road_dynamic_label", "road_dynamic_annotation", True, 2000)):
        for i, name in enumerate(labels_in(sub)):
            objs = read_label(os.path.join(kitti_labeled_dir, sub, name))
            annos = None if anno_sub is None else _annotations(
                os.path.join(kitti_labeled_dir, anno_sub, name))
            sc = convert_gt_scenario(objs, annos, is_highway, direction,
                                     cfg, seed=seed + base + i)
            stem = name.rsplit(".", 1)[0]
            sc.benchmark_id = stem
            path = os.path.join(out_dir, stem + ".xml")
            write_scenario(sc, path)
            written.append(path)
    return written
