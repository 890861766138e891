"""The ego vehicle's parameters.

Counterpart of eval_driving_safety_tpu/safety/vehicle.py: CommonRoad
vehicle model 2 (BMW 320i), whose box the planner and the collision
checker sweep and whose kinematic single-track model the primitives
integrate.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VehicleParams:
    name: str
    length: float            # l  [m]
    width: float             # w  [m]
    wheelbase: float         # a + b [m]
    steering_min: float      # delta min [rad]
    steering_max: float
    steering_v_min: float    # steering rate bounds [rad/s]
    steering_v_max: float
    v_min: float             # longitudinal velocity bounds [m/s]
    v_max: float
    a_max: float             # max acceleration [m/s^2]


# CommonRoad vehicle model 2 (BMW 320i)
BMW320I = VehicleParams(
    name="BMW_320i",
    length=4.508,
    width=1.610,
    wheelbase=2.578,         # a=1.1561957064, b=1.4227170936
    steering_min=-1.066,
    steering_max=1.066,
    steering_v_min=-0.4,
    steering_v_max=0.4,
    v_min=-13.6,
    v_max=50.8,
    a_max=11.5,
)
