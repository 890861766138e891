"""The framework's whole story on one detector: overfit a DSGN on a
synthetic stereo scene with one planted car, detect the car, PGD-attack
the trained detector, then turn the clean and the attacked detections
into CommonRoad scenarios, plan on each and collision-check the plans
against the true scene, so that the safety metrics flip.

Counterpart of examples/end_to_end_demo.py: the same scene, recipe
(Adam at 2e-3, 400 steps), attack (8 iterations, alpha 2/255, eps 0.1,
views clipped to [0, 1]) and safety check, as functions:
`make_scene`, `overfit`, `detect` + `describe`, `attack`, `to_objects` +
`safety`, and `run`, which returns what the JAX script prints after
"METRICS ". Two scales:
* tiny: `DSGNConfig.tiny()` and the JAX script's camera (f_u 200 px,
  baseline 0.54 m, principal point at the image centre);
* train: `DSGNConfig()` (384 x 1248, 64 planes, bf16), the configuration
  of the DSGN trainer, with the same car and ego goal seen through
  `Calibration.default()`'s KITTI camera.
The car stands on the ego's straight path to its goal: a right detection
makes the planner go around it, a lost or displaced one lets the plan
run through the real car.

Usage:
  python -m eval_driving_safety_tpu_torch.examples.end_to_end_demo \\
      [--scale tiny|train] [--steps 400] [--seed 0] [--device cuda]
`--device cpu` runs the kernels' plain versions. The exit code is 1 when
the clean detection misses the car by 3 m or more.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from eval_driving_safety_tpu_torch.attack.pgd import PGDResult, pgd_attack
from eval_driving_safety_tpu_torch.cli.common import (
    add_device_args, use_deterministic_kernels)
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.data.kitti import Calibration, KittiObject
from eval_driving_safety_tpu_torch.inference.fcos3d_post import (
    Detections3D, decode_bev_outputs, fetch_detections)
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.models.rpn3d_loss import dsgn_total_loss
from eval_driving_safety_tpu_torch.safety.collision import collides
from eval_driving_safety_tpu_torch.safety.convert import \
    convert_detection_scenario
from eval_driving_safety_tpu_torch.safety.planner import plan_scenario

# the car, on the ego's straight path to the goal (x ~ 0, 10 m ahead)
CAR = dict(x=0.0, y=1.6, z=10.0, h=1.5, w=1.7, l=4.0, ry=0.0)
TINY_F_U, BASELINE = 200.0, 0.54
# the depth target's half height and width on the car, in pixels at the
# tiny camera's focal length; scaled with the focal length elsewhere
DEPTH_HALF = (6, 8)
LR = 2e-3
ATTACK = dict(num_iters=8, alpha=2 / 255, eps=0.1)
LOCALIZED_M = 3.0
SCALES = ("tiny", "train")


def scale_setup(scale: str):
    """(config, camera) of a scale."""
    if scale == "tiny":
        cfg = DSGNConfig.tiny()
        return cfg, Calibration.default(
            f_u=TINY_F_U, c_u=cfg.width / 2.0, c_v=cfg.height / 2.0,
            baseline=BASELINE)
    if scale == "train":
        return DSGNConfig(), Calibration.default()
    raise ValueError(f"scale {scale!r}: one of {SCALES}")


class Scene(NamedTuple):
    """The stereo pair in [0, 1] (1, H, W, 3), the calibration (f_u,
    baseline, c_u, c_v) as (1,) tensors, the car as the loss's boxes
    (1, 8, 8) with `num_boxes`, and the depth target (1, H, W), zero but
    on the car."""
    left: torch.Tensor
    right: torch.Tensor
    calib: tuple
    boxes3d: torch.Tensor
    num_boxes: torch.Tensor
    depth: torch.Tensor

    def to(self, device) -> "Scene":
        return Scene(*(tuple(t.to(device) for t in v) if isinstance(v, tuple)
                       else v.to(device) for v in self))


def make_scene(cfg: DSGNConfig, calib: Calibration) -> Scene:
    """The textured car painted on a noise field in both views, the right
    view shifted by the car's disparity (the JAX script's scene, in its
    arithmetic, so that the tiny scale's arrays are its bits)."""
    h, w = cfg.height, cfg.width
    f_u, cu, cv = calib.f_u, calib.c_u, calib.c_v
    rng = np.random.RandomState(0)
    bg = rng.rand(h, w + 64, 3).astype(np.float32) * 0.3

    def render_view(shift_px: float) -> np.ndarray:
        img = bg[:, 32: 32 + w].copy()
        u = int(f_u * CAR["x"] / CAR["z"] + cu - shift_px)
        v = int(f_u * (CAR["y"] - CAR["h"] / 2) / CAR["z"] + cv)
        du = max(int(f_u * CAR["l"] / CAR["z"] / 2), 6)
        dv = max(int(f_u * CAR["h"] / CAR["z"] / 2), 4)
        texture = np.random.RandomState(7).rand(2 * dv, 2 * du, 3).astype(
            np.float32) * 0.6 + 0.4
        img[v - dv: v + dv, u - du: u + du] = texture[: 2 * dv, : 2 * du]
        return img

    disp = f_u * calib.baseline / CAR["z"]
    boxes3d = np.zeros((1, 8, 8), np.float32)
    boxes3d[0, 0] = [CAR["x"], CAR["y"], CAR["z"], CAR["h"], CAR["w"],
                     CAR["l"], CAR["ry"], 1.0]
    depth = np.zeros((1, h, w), np.float32)
    u0 = int(f_u * CAR["x"] / CAR["z"] + cu)
    v0 = int(f_u * (CAR["y"] - CAR["h"] / 2) / CAR["z"] + cv)
    hv, hu = (round(n * f_u / TINY_F_U) for n in DEPTH_HALF)
    depth[0, v0 - hv: v0 + hv, u0 - hu: u0 + hu] = CAR["z"]
    t = torch.from_numpy
    return Scene(t(render_view(0.0))[None], t(render_view(disp))[None],
                 tuple(torch.tensor([v], dtype=torch.float32)
                       for v in (f_u, calib.baseline, cu, cv)),
                 t(boxes3d), torch.tensor([1]), t(depth))


def forward(model: DSGN, scene: Scene, left, right) -> dict:
    """The detector's outputs on a pair in [0, 1], ImageNet-normalized
    here, with the scene's calibration."""
    mean = torch.tensor(model.cfg.input.mean, device=left.device)
    std = torch.tensor(model.cfg.input.std, device=left.device)
    return model((left - mean) / std, (right - mean) / std, *scene.calib)


def scene_loss(model: DSGN, scene: Scene, left, right) -> torch.Tensor:
    """The detector's total loss on a pair in [0, 1]: the objective of
    both the training and the attack."""
    return dsgn_total_loss(forward(model, scene, left, right), scene.depth,
                           scene.boxes3d, scene.num_boxes, model.cfg)[0]


def optimizer(model: DSGN, lr: float = LR) -> torch.optim.Adam:
    """optax.adam(lr) over every parameter, the FrozenBatchNorm statistics
    included: betas 0.9 / 0.999, eps 1e-8 added after the square root,
    no decay, no clipping."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def overfit(model: DSGN, scene: Scene, steps: int, lr: float = LR) -> dict:
    """`steps` steps of `optimizer(model, lr)` on the scene's loss.
    Returns {step: loss} every 100 steps and at the last."""
    opt = optimizer(model, lr)
    losses = {}
    for step in range(steps):
        total = scene_loss(model, scene, scene.left, scene.right)
        opt.zero_grad()
        total.backward()
        opt.step()
        if step % 100 == 0 or step == steps - 1:
            losses[step] = float(total.detach())
    return losses


def detect(model: DSGN, scene: Scene, left, right) -> Detections3D:
    """Decoded detections on a pair in [0, 1], at the config's score
    threshold, fetched to the host."""
    with torch.no_grad():
        return fetch_detections(decode_bev_outputs(
            forward(model, scene, left, right), model.cfg))


def describe(dets: Detections3D, tag: str) -> Optional[dict]:
    """The top detection (count, score, BEV error to the car in metres,
    box), or None without one."""
    n = int(dets.valid[0].sum())
    if n == 0:
        print(f"{tag}: NO detections")
        return None
    b = dets.boxes3d[0, 0]
    s = float(dets.scores[0, 0])
    err = float(np.hypot(b[0] - CAR["x"], b[2] - CAR["z"]))
    print(f"{tag}: {n} dets; top score {s:.3f}, BEV pos "
          f"({b[0]:.2f}, {b[2]:.2f}) vs gt ({CAR['x']}, {CAR['z']}) "
          f"-> err {err:.2f} m")
    return dict(n=n, score=s, err=err, box=b)


def attack(model: DSGN, scene: Scene) -> PGDResult:
    """White-box L-inf PGD on both views of the scene, ascending the
    detector's loss. The model's weights should be frozen
    (`requires_grad_(False)`), or the backward computes their gradients
    too."""
    return pgd_attack(lambda l, r: scene_loss(model, scene, l, r),
                      scene.left, scene.right, clip_min=0.0, clip_max=1.0,
                      **ATTACK)


def to_objects(det: Optional[dict]) -> list:
    """A detection from `describe` as the KITTI object the scenario
    converter reads; none without one."""
    if det is None:
        return []
    b = det["box"]
    return [KittiObject(
        type="Car", truncated=0, occluded=0, alpha=0.0,
        bbox=np.array([0, 0, 10, 10.0]),
        dimensions=np.array([b[3], b[4], b[5]]),
        location=np.array([b[0], b[1], b[2]]), rotation_y=float(b[6]))]


def true_scenario(clean: Optional[dict]):
    """The ground-truth scenario: the clean detection's box at the car's
    true pose (without a clean detection, the car's own box)."""
    if clean is None:
        clean = dict(box=np.array([CAR[k] for k in "xyzhwl"] + [CAR["ry"]],
                                  np.float32))
    gt = convert_detection_scenario(to_objects(clean), is_highway=False)
    gt.static_obstacles[0].initial_state.position = np.array(
        [CAR["z"], -CAR["x"]])
    return gt


def safety(tag: str, det_objs: list, gt_scenario) -> dict:
    """Plan on the scenario of `det_objs` and check the plan against the
    ground-truth scenario: {"success", "collision"} as 0 or 1."""
    scen = convert_detection_scenario(det_objs, is_highway=False)
    traj = plan_scenario(scen, is_highway=False)
    if traj is None:
        print(f"{tag}: planning FAILED (no path found)")
        return {"success": 0, "collision": 0}
    hit = collides(gt_scenario, traj)
    print(f"{tag}: planned {len(traj.states)} states; collision vs GT "
          f"scene: {hit}")
    return {"success": 1, "collision": int(hit)}


def weights_digest(model: DSGN) -> str:
    """SHA-256 of every parameter's bytes, in name order."""
    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run(scale: str = "tiny", device="cuda", steps: int = 400, seed: int = 0,
        stats: Optional[dict] = None) -> dict:
    """The whole story, printed as the JAX script prints it. Returns its
    METRICS: the clean and attacked safety metrics, the clean top score
    and error, the attacked top score (0 without a detection) and the
    attack's loss ascent. A clean run that finds nothing gives score 0
    and an infinite error. `stats`, if given, is filled with the losses,
    the stages' times, both top detections and the trained weights'
    digest."""
    if steps < 1:
        raise ValueError(f"steps {steps}: at least 1")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: --device cpu runs the kernels' "
                           "plain versions")
    use_deterministic_kernels(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    cfg, calib = scale_setup(scale)
    scene = make_scene(cfg, calib).to(device)
    model = DSGN(cfg).init_weights(seed).to(device)
    times = {}

    def lap(name, t0):
        sync()
        times[name] = time.perf_counter() - t0
        return time.perf_counter()

    print(f"training {scale} DSGN on the synthetic scene ...")
    t = time.perf_counter()
    losses = overfit(model, scene, steps)
    t = lap("train_s", t)
    for step, loss in losses.items():
        if step % 100 == 0:
            print(f"  step {step}: loss {loss:.4f}")
    print(f"  final loss {losses[steps - 1]:.4f}")
    model.requires_grad_(False)

    clean = describe(detect(model, scene, scene.left, scene.right), "clean")
    t = lap("detect_s", t)
    print(f"running PGD attack (iters={ATTACK['num_iters']}, "
          f"eps={ATTACK['eps']}) ...")
    res = attack(model, scene)
    attack_losses = res.losses.float().cpu().numpy()
    t = lap("attack_s", t)
    adv = describe(detect(model, scene, res.adv_left, res.adv_right),
                   "attacked")
    t = lap("adv_detect_s", t)
    print(f"  attack loss ascent: {float(attack_losses[0]):.3f} -> "
          f"{float(attack_losses[-1]):.3f}")

    gt = true_scenario(clean)
    m_clean = safety("clean detections ", to_objects(clean), gt)
    m_adv = safety("attacked detections", to_objects(adv), gt)
    lap("safety_s", t)
    print("\n=== safety metrics (1 scenario) ===")
    print(f"successful planning rate: clean {m_clean['success']:.0%} -> "
          f"attacked {m_adv['success']:.0%}")
    print(f"collision rate:           clean {m_clean['collision']} -> "
          f"attacked {m_adv['collision']}")
    if stats is not None:
        found = lambda d: None if d is None else dict(
            n=d["n"], score=d["score"], err=d["err"],
            box=[float(v) for v in d["box"]])
        stats.update(
            steps=steps, losses=losses, attack_losses=attack_losses.tolist(),
            clean_detection=found(clean), adv_detection=found(adv),
            weights_sha256=weights_digest(model), **times,
            train_ms_per_step=1e3 * times["train_s"] / steps,
            pgd_ms_per_iter=1e3 * times["attack_s"] / ATTACK["num_iters"])
    return {
        "clean": m_clean, "adv": m_adv,
        "clean_score": clean["score"] if clean else 0.0,
        "clean_err": clean["err"] if clean else float("inf"),
        "adv_score": adv["score"] if adv else 0.0,
        "attack_ascent": float(attack_losses[-1]) - float(attack_losses[0]),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scale", choices=SCALES, default="tiny")
    p.add_argument("--steps", type=int, default=400,
                   help="Adam steps of the overfit")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the initial weights")
    add_device_args(p)
    return p.parse_args(argv)


def main(argv=None, stats: Optional[dict] = None) -> int:
    """Run the story, print its METRICS line, then DONE; 1 (and no DONE)
    when the clean detection missed the car. `stats` as in `run`."""
    args = parse_args(argv)
    m = run(args.scale, args.device, args.steps, args.seed, stats)
    print("METRICS " + json.dumps(m))
    if not m["clean_err"] < LOCALIZED_M:
        print(f"training failed to localize the planted car (error "
              f"{m['clean_err']:.2f} m)")
        return 1
    print("DONE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
