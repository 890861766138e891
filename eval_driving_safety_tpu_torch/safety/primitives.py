"""Motion primitives of the kinematic single-track (KS) model.

Counterpart of eval_driving_safety_tpu/safety/primitives.py, bank for
bank the same arrays: each maneuver forward-simulates

    x' = v cos(psi),  y' = v sin(psi),
    delta' = v_delta, v' = a, psi' = v / L tan(delta)

with constant input rates over T = 0.5 s, sampled every dt = 0.1 s, by
the same 10-substep Euler in Python floats. The street band samples
6 and 8 m/s, the highway band 11 and 13; steering from -1.066 to 1.066
rad in steps of 0.36, moving at most one sample a maneuver.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np

from eval_driving_safety_tpu_torch.config import PlannerConfig
from eval_driving_safety_tpu_torch.safety.vehicle import BMW320I, VehicleParams


@dataclass(frozen=True)
class MotionPrimitive:
    """One maneuver: (v0, sa0) -> (v1, sa1) over T seconds.

    `states` is a (K+1, 5) array of (x, y, orientation, velocity,
    steering_angle) starting at the origin pose; row 0 is the start state.
    """
    v_start: float
    v_end: float
    sa_start: float
    sa_end: float
    states: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.states.shape[0] - 1


def simulate_ks(v0: float, sa0: float, v1: float, sa1: float, *,
                duration: float, dt: float,
                vehicle: VehicleParams = BMW320I) -> np.ndarray:
    """Integrate the KS model with constant a and v_delta: Euler with 10
    substeps per dt (the 0.5 s arc to better than 1 mm)."""
    n = int(round(duration / dt))
    a = (v1 - v0) / duration
    vd = (sa1 - sa0) / duration
    sub = 10
    h = dt / sub
    x = y = psi = 0.0
    v, sa = v0, sa0
    out = [(x, y, psi, v, sa)]
    for _ in range(n):
        for _ in range(sub):
            x += v * math.cos(psi) * h
            y += v * math.sin(psi) * h
            psi += v / vehicle.wheelbase * math.tan(sa) * h
            v += a * h
            sa += vd * h
        out.append((x, y, psi, v, sa))
    return np.asarray(out)


def sample_values(lo: float, hi: float, step: float) -> List[float]:
    """Inclusive sampling; step <= 0 means just the endpoints."""
    if step <= 0:
        return [lo, hi] if hi > lo else [lo]
    vals = list(np.arange(lo, hi + 1e-9, step))
    if abs(vals[-1] - hi) > 1e-6:
        vals.append(hi)
    return [float(v) for v in vals]


def generate_primitives(vmin: float, vmax: float, vstep: float,
                        cfg: PlannerConfig = PlannerConfig(),
                        vehicle: VehicleParams = BMW320I
                        ) -> List[MotionPrimitive]:
    """Every primitive of one velocity band: steering moves to an adjacent
    sample or stays, velocity to any sample within a_max * T."""
    v_samples = sample_values(vmin, vmax, vstep)
    sa_samples = sample_values(cfg.steering_min, cfg.steering_max,
                               cfg.steering_step)
    max_dv = vehicle.a_max * cfg.primitive_duration
    prims = []
    for v0 in v_samples:
        for v1 in v_samples:
            if abs(v1 - v0) > max_dv + 1e-9:
                continue
            for sa0 in sa_samples:
                for sa1 in sa_samples:
                    if abs(sa1 - sa0) > cfg.steering_step + 1e-9:
                        continue
                    states = simulate_ks(
                        v0, sa0, v1, sa1,
                        duration=cfg.primitive_duration, dt=cfg.dt,
                        vehicle=vehicle)
                    prims.append(MotionPrimitive(v0, v1, sa0, sa1, states))
    return prims


@lru_cache(maxsize=8)
def primitives_for_band(is_highway: bool,
                        cfg: PlannerConfig = PlannerConfig()
                        ) -> List[MotionPrimitive]:
    """The street (6-8 m/s, endpoints) or highway (11-13, step 2) bank,
    built once per (band, config)."""
    band = cfg.highway_v if is_highway else cfg.street_v
    return generate_primitives(band[0], band[1], band[2], cfg)


def transform_states(states: np.ndarray, x: float, y: float,
                     psi: float) -> np.ndarray:
    """Rigid-transform primitive-local states into the world pose."""
    c, s = math.cos(psi), math.sin(psi)
    out = states.copy()
    out[:, 0] = x + c * states[:, 0] - s * states[:, 1]
    out[:, 1] = y + s * states[:, 0] + c * states[:, 1]
    out[:, 2] = psi + states[:, 2]
    return out
