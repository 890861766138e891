"""The Stereo R-CNN full story: overfit the detector on a synthetic stereo
scene with one planted car until it detects the car, then PGD-attack the
trained detector and show the detection degrade.

Counterpart of tests/srcnn_e2e_driver.py: the same scene, recipe (the
network and the six loss weights `uncert` descending
`total_attack_loss` together under optax's chain of a global-norm clip
at 10 and Adam at 1e-3, fresh sampler draws every step), probe schedule
(a loss logged every 250 steps; from step 1,250 a probe every 250 steps,
stopping at the first Car within IoU 0.3 of the box), and attack (8
iterations, alpha 3, eps 255 x 0.3, clipped to the per-channel pixel
bounds, the draws fixed), as functions: `make_scene`, `optimizer`,
`overfit`, `detections` + `hits`, `attack`, and `run`, which returns
the driver's JSON line with the stages' times. Two scales:
* tiny: `StereoRCNNConfig.tiny()` (96 x 320) and the driver's scene bit
  for bit: its camera (f_u 200 px, principal point (160, 48)) and its
  literal box [140, 40, 180, 70], which is not the car's projection
  through that camera (the car would span about 28 px, not 40);
* train: `StereoRCNNConfig()` (ResNet-101 FPN, 600 x 1984, fp32 with
  TF32 off, the Stereo R-CNN trainer's precision). The same car at the
  same place, seen through `Calibration.default()`'s KITTI camera scaled
  to the network size as the ingest scales a 375-row frame (600 / 375,
  the first two rows of P2 and P3). Its box is the 3D box's projection
  through that camera, widened to whole pixels, and the texture covers
  it; the right view's shift is f_u x 0.54 / 12 truncated, as the driver
  truncates its own. That one calibration makes the gt, solves the
  probe's boxes and places the box of the IoU.

Usage:
  python -m eval_driving_safety_tpu_torch.examples.srcnn_end_to_end \\
      [--scale tiny|train] [--steps 2500] [--probe_from 1250] \\
      [--probe_every 250] [--seed 0] [--device cuda]
`--steps` is the index of the last training step (the driver's loop is
`range(2501)`). The last line printed is the JSON result; the exit code
is 1 when no probe found the car.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from eval_driving_safety_tpu_torch.attack.pgd import PGDResult, pgd_attack
from eval_driving_safety_tpu_torch.cli.common import (
    add_device_args, use_deterministic_kernels, use_srcnn_precision)
from eval_driving_safety_tpu_torch.cli.train_detector import \
    DetectorOptimizer
from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.data.dataset import srcnn_clip_bounds
from eval_driving_safety_tpu_torch.data.kitti import Calibration, KittiObject
from eval_driving_safety_tpu_torch.inference.stereo_rcnn_predict import (
    fetch_outputs, predict_image)
from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
    StereoRCNN, make_gt_batch, total_attack_loss)
from eval_driving_safety_tpu_torch.models.stereo_targets import \
    SamplingDraws

# the car: bottom centre (x, y, z) in the rectified camera, m; yaw
CAR = dict(x=0.5, y=1.6, z=12.0, ry=math.pi / 2, h=1.5, w=1.7, l=4.0)
BASELINE = 0.54
TINY_BBOX = np.array([140.0, 40.0, 180.0, 70.0])
# the ingest's scale of a 375-row KITTI frame to the 600-row input
TRAIN_SCALE = 600 / 375
LR, CLIP_NORM = 1e-3, 10.0
TRAIN_SEED, ATTACK_SEED = 2, 5
LOG_EVERY = 250
ATTACK = dict(num_iters=8, alpha=3.0, eps=255.0 * 0.3)
HIT_IOU = 0.3
SCALES = ("tiny", "train")


def config(scale: str) -> StereoRCNNConfig:
    if scale == "tiny":
        return StereoRCNNConfig.tiny()
    if scale == "train":
        return StereoRCNNConfig()
    raise ValueError(f"scale {scale!r}: one of {SCALES}")


class Scene(NamedTuple):
    """The stereo pair in the network's pixel space (BGR x 255 minus the
    means) (1, H, W, 3), the gt dict of `make_gt_batch`, the calibration
    and the car's 2D box [x1, y1, x2, y2] in the left view."""
    left: torch.Tensor
    right: torch.Tensor
    gt: dict
    calib: Calibration
    box: np.ndarray

    def to(self, device) -> "Scene":
        return self._replace(left=self.left.to(device),
                             right=self.right.to(device),
                             gt={k: v.to(device) for k, v in self.gt.items()})


def train_calibration() -> Calibration:
    """`Calibration.default()` at the network size: the first two rows of
    P2 and P3 scaled by 600 / 375."""
    c = Calibration.default()
    s = np.diag([TRAIN_SCALE, TRAIN_SCALE, 1.0])
    return Calibration(P2=s @ c.P2, P3=s @ c.P3)


def projected_box(calib: Calibration) -> np.ndarray:
    """The car's 3D box projected through `calib`, widened to whole
    pixels: [floor x1, floor y1, ceil x2, ceil y2]."""
    l, w, h, ry = CAR["l"], CAR["w"], CAR["h"], CAR["ry"]
    xs = np.array([1, 1, -1, -1] * 2) * l / 2
    zs = np.array([1, -1, -1, 1] * 2) * w / 2
    ys = np.array([0.0] * 4 + [-h] * 4)
    c, s = math.cos(ry), math.sin(ry)
    pts = np.stack([CAR["x"] + c * xs + s * zs, CAR["y"] + ys,
                    CAR["z"] - s * xs + c * zs], axis=1)
    uv = calib.project_rect_to_image(pts)
    lo, hi = np.floor(uv.min(axis=0)), np.ceil(uv.max(axis=0))
    return np.array([lo[0], lo[1], hi[0], hi[1]])


def make_scene(scale: str) -> Scene:
    """The textured car painted on a noise field in both views, the right
    view's car shifted left by the car's disparity, in the driver's
    arithmetic (so that the tiny scale's arrays are its bits)."""
    cfg = config(scale)
    H, W = cfg.input.height, cfg.input.width
    if scale == "tiny":
        calib = Calibration.default(f_u=200.0, c_u=160.0, c_v=48.0)
        box = TINY_BBOX.copy()
    else:
        calib = train_calibration()
        box = projected_box(calib)
    obj = KittiObject(type="Car", truncated=0, occluded=0, alpha=0.1,
                      bbox=box.copy(),
                      dimensions=np.array([CAR["h"], CAR["w"], CAR["l"]]),
                      location=np.array([CAR["x"], CAR["y"], CAR["z"]]),
                      rotation_y=CAR["ry"])
    x1, y1, x2, y2 = (int(v) for v in box)
    bg = np.random.RandomState(0).rand(H, W, 3).astype(np.float32) * 0.3
    disp = int(calib.f_u * BASELINE / CAR["z"])
    tex = np.random.RandomState(7).rand(y2 - y1, x2 - x1, 3).astype(
        np.float32) * 0.6 + 0.4
    im_l = bg.copy()
    im_l[y1:y2, x1:x2] = tex
    im_r = bg.copy()
    im_r[y1:y2, x1 - disp:x2 - disp] = tex
    pm = np.array(cfg.input.pixel_means_bgr, np.float32)
    to_net = lambda x: (x[..., ::-1] * 255.0) - pm
    gt = make_gt_batch([[obj]], [calib], cfg)
    return Scene(torch.from_numpy(to_net(im_l))[None],
                 torch.from_numpy(to_net(im_r))[None], gt, calib, box)


def optimizer(model: StereoRCNN, uncert: torch.Tensor,
              lr: float = LR) -> DetectorOptimizer:
    """optax.chain(clip_by_global_norm(10), adam(lr)) over every
    parameter, the FrozenBatchNorm statistics and `uncert` included: the
    gradients scaled together by min(1, 10 / global norm), then Adam
    (betas 0.9 / 0.999, eps 1e-8 added after the square root), no
    decay."""
    params = [*model.parameters(), uncert]
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return DetectorOptimizer(adam, params, lambda n: lr, CLIP_NORM)


def scene_loss(model: StereoRCNN, uncert: torch.Tensor, scene: Scene,
               left, right, draws: SamplingDraws) -> torch.Tensor:
    """The detector's `total_attack_loss` on a pair: the objective of both
    the training and the attack."""
    out = model(left, right, gt=scene.gt, draws=draws, mode="attack")
    return total_attack_loss(out.losses, uncert)


def iou(a, b) -> float:
    """The driver's IoU of two [x1, y1, x2, y2] boxes."""
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def hits(dets: List[dict], box) -> List[dict]:
    """The detections that find the car: Cars within IoU 0.3 of `box`."""
    return [d for d in dets if d["type"] == "Car"
            and iou(d["bbox"], box) > HIT_IOU]


def detections(model: StereoRCNN, scene: Scene, left, right) -> List[dict]:
    """KITTI detection dicts of a pair: `mode="infer"`, one fetch, the
    host decode and solve through the scene's calibration, no dense
    alignment (None images: the driver's `dense_align=False`)."""
    cfg = model.cfg
    with torch.no_grad():
        out = model(left, right, mode="infer")
    return predict_image(fetch_outputs(out), None, None, scene.calib, cfg,
                         image_hw=(cfg.input.height, cfg.input.width))


def weights_digest(model: StereoRCNN, uncert: torch.Tensor) -> str:
    """SHA-256 of every parameter's bytes in name order, then `uncert`'s."""
    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    h.update(uncert.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def overfit(model: StereoRCNN, uncert: torch.Tensor, scene: Scene,
            steps: int, draws: Optional[Callable[[int], SamplingDraws]] = None,
            probe_from: int = 1250, probe_every: int = 250,
            digest_after: Optional[int] = None, log=print) -> dict:
    """Up to `steps` steps of `optimizer(model, uncert)` on the scene's
    loss, numbered from 0. After step i, a logged loss where i % 250 ==
    0, and a probe where i >= probe_from and i % probe_every == 0; the
    first probe with a hit ends the training. `draws(i)` gives step i's
    sampler draws (default: `model.sample_draws(1, gen)` from one
    generator seeded 2 on the model's device). Returns {"losses": every
    step's loss, "logged": {step: loss}, "probes": [(step, hits)],
    "best": the best-scoring hit or None, "step": the step of that probe
    or None, "train_s", "probe_s" (each stage's seconds), "sha256": the
    weights' digest after `digest_after` steps}."""
    if steps < 1:
        raise ValueError(f"steps {steps}: at least 1")
    device = scene.left.device
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
        draws = lambda i: model.sample_draws(1, gen)
    opt = optimizer(model, uncert)
    losses, logged, probes = [], {}, []
    best, found, sha = None, None, None
    probe_s = 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        total = scene_loss(model, uncert, scene, scene.left, scene.right,
                           draws(i))
        opt.zero_grad()
        total.backward()
        opt.step()
        losses.append(total.detach())
        if digest_after is not None and i + 1 == digest_after:
            sha = weights_digest(model, uncert)
        if i % LOG_EVERY == 0:
            logged[i] = float(losses[-1])
            log(f"# step {i} loss {logged[i]:.2f} "
                f"{time.perf_counter() - t0:.0f}s")
        if i >= probe_from and i % probe_every == 0:
            _sync(device)
            tp = time.perf_counter()
            found_now = hits(detections(model, scene, scene.left,
                                        scene.right), scene.box)
            probe_s += time.perf_counter() - tp
            probes.append((i, len(found_now)))
            log(f"# probe {i}: {len(found_now)} hits "
                f"{time.perf_counter() - t0:.0f}s")
            if found_now:
                best = max(found_now, key=lambda d: d["score"])
                found = i
                break
    _sync(device)
    wall = time.perf_counter() - t0
    return dict(losses=torch.stack(losses).cpu().numpy(), logged=logged, probes=probes, best=best, step=found,
                train_s=wall - probe_s, probe_s=probe_s, sha256=sha)


def attack(model: StereoRCNN, uncert: torch.Tensor, scene: Scene,
           draws: Optional[SamplingDraws] = None,
           collect=False) -> PGDResult:
    """The driver's PGD on both views (8 iterations, alpha 3, eps 76.5,
    clipped to `srcnn_clip_bounds`), ascending the scene's loss with the
    samplers' draws fixed over the iterations (default: one draw from a
    generator seeded 5 on the scene's device). Freeze the model's weights
    (`requires_grad_(False)`) first, or the backward computes their
    gradients too."""
    if draws is None:
        gen = torch.Generator(device=scene.left.device).manual_seed(
            ATTACK_SEED)
        draws = model.sample_draws(1, gen)
    cmin, cmax = srcnn_clip_bounds(model.cfg.input)
    return pgd_attack(
        lambda l, r: scene_loss(model, uncert, scene, l, r, draws),
        scene.left, scene.right, clip_min=cmin, clip_max=cmax,
        collect=collect, **ATTACK)


def attacked(model: StereoRCNN, uncert: torch.Tensor, scene: Scene) -> dict:
    """The attack on the trained detector and its outcome: the loss at
    each iteration, the largest pixel change in either view, the best
    hit's score on the attacked pair (0 without one), and the stage's
    seconds."""
    model.requires_grad_(False)
    uncert = uncert.detach()
    device = scene.left.device
    _sync(device)
    t0 = time.perf_counter()
    res = attack(model, uncert, scene)
    losses = res.losses.cpu().numpy()
    t_attack = time.perf_counter() - t0
    adv = hits(detections(model, scene, res.adv_left, res.adv_right),
               scene.box)
    delta = max(float((res.adv_left - scene.left).abs().max()),
                float((res.adv_right - scene.right).abs().max()))
    return dict(attack_losses=[float(x) for x in losses], max_delta=delta,
                adv_score=max((d["score"] for d in adv), default=0.0),
                attack_s=t_attack)


def frozen_var(model: StereoRCNN) -> torch.Tensor:
    """Every FrozenBatchNorm `var` of the model, flat: the optimizer
    moves them, and rsqrt(var + eps) turns NaN below -eps."""
    return torch.cat([p.detach().flatten() for n, p in
                      model.named_parameters() if n.endswith(".var")])


def setup(scale: str, seed: int, device):
    """The scale's scene on `device`, the model initialised from `seed`
    and `uncert` at 0; the card's precision and determinism set."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: --device cpu runs on the CPU")
    use_deterministic_kernels(device)
    cfg = config(scale)
    use_srcnn_precision(cfg)
    scene = make_scene(scale).to(device)
    model = StereoRCNN(cfg).init_weights(seed).to(device)
    uncert = torch.nn.Parameter(torch.zeros(6, device=device))
    return scene, model, uncert


def run(scale: str = "tiny", steps: int = 2500, probe_from: int = 1250,
        probe_every: int = 250, seed: int = 0, device="cuda",
        stats: Optional[dict] = None, digest_after: Optional[int] = None,
        log=print) -> dict:
    """The driver's story: train with probes up to step index `steps`,
    and on a hit attack and probe the attacked pair. Returns the driver's
    line (ok, steps, clean_score, clean_iou, attack_losses, max_delta,
    adv_score; or ok false with why "no detection") and the stages'
    times: ms a training step, ms a probe, ms a PGD iteration, wall
    seconds. `stats`, if given, is filled with overfit's record (every
    step's loss, the logged losses, the probes, the weights' digest
    after `digest_after` steps), the smallest `frozen_var` after
    training (`var_min`) and whether every parameter is finite
    (`finite`)."""
    t0 = time.perf_counter()
    scene, model, uncert = setup(scale, seed, device)
    log(f"# training {scale} Stereo R-CNN on the planted-car scene")
    tr = overfit(model, uncert, scene, steps + 1, probe_from=probe_from,
                 probe_every=probe_every, digest_after=digest_after, log=log)
    var = frozen_var(model)
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"# trained: FrozenBatchNorm var in [{float(var.min()):.4f}, "
        f"{float(var.max()):.4f}], every parameter finite: {finite}")
    if stats is not None:
        stats.update(tr, var_min=float(var.min()), finite=finite)
    times = {"train_ms_per_step": 1e3 * tr["train_s"] / len(tr["losses"]),
             "probe_ms": 1e3 * tr["probe_s"] / len(tr["probes"])
             if tr["probes"] else None}
    if tr["best"] is None:
        times["wall_s"] = time.perf_counter() - t0
        return {"ok": False, "why": "no detection", **times}
    best = tr["best"]
    out = {"ok": True, "steps": tr["step"],
           "clean_score": float(best["score"]),
           "clean_iou": float(iou(best["bbox"], scene.box))}
    adv = attacked(model, uncert, scene)
    out.update(attack_losses=adv["attack_losses"],
               max_delta=adv["max_delta"], adv_score=adv["adv_score"])
    times["pgd_ms_per_iter"] = 1e3 * adv["attack_s"] / ATTACK["num_iters"]
    times["wall_s"] = time.perf_counter() - t0
    return {**out, **times}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scale", choices=SCALES, default="tiny")
    p.add_argument("--steps", type=int, default=2500,
                   help="index of the last training step")
    p.add_argument("--probe_from", type=int, default=1250)
    p.add_argument("--probe_every", type=int, default=250)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the initial weights")
    add_device_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the story and print its JSON line last; 1 when no probe found
    the car."""
    args = parse_args(argv)
    res = run(args.scale, args.steps, args.probe_from, args.probe_every,
              args.seed, args.device,
              log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
