"""Detector training CLI: DSGN and Stereo R-CNN on one CUDA card.

Counterpart of `eval_driving_safety_tpu.cli.train_detector`, with the
same flags, optimizer, schedule and checkpoint layout:
`{ckpt_dir}/epoch{N}/` every `--ckpt_every` epochs and after the last,
written by utils.checkpoint with `torch.save`. `--resume` continues from
the newest `epoch{N}/`, the port's or the JAX trainer's orbax directory:
its Flax parameters go through utils.from_flax and its optax state
becomes the optimizer's exactly (`detector_state_from_optax`). A last
batch of fewer than `--batch` frames is dropped.
* dsgn: `DSGNConfig()` (`--tiny`: `DSGNConfig.tiny()`), initialised from
  `--seed`; the objective is `dsgn_total_loss`, whose disparity term
  trains only with `--depth_dir` (depth maps from cli.make_depth_gt).
* srcnn: `StereoRCNNConfig()` in float32 with TF32 off (`--tiny`: the
  tiny config), initialised from `--seed`; the network and the six loss
  weights `uncert` (from 0) descend `total_attack_loss` together, the
  samplers drawing afresh at every step from a generator seeded
  `--seed` + 1. Frames go up as u8 and are resized on the card exactly
  as the attack ingests them. Checkpoints hold `params`, `uncert`,
  `opt_state` and `epoch`; the attack, predict and patch CLIs take them
  as `--ckpt`.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.train_detector --detector dsgn \\
      --data_path KITTI/object/training --split_file train.txt \\
      --depth_dir depth_gt --epochs 20 --batch 1 --ckpt_dir ckpts/dsgn
  python -m eval_driving_safety_tpu_torch.cli.train_detector --detector srcnn \\
      --data_path KITTI/object/training --split_file train.txt \\
      --epochs 12 --ckpt_dir ckpts/srcnn
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, log, make_dataset,
    use_deterministic_kernels, use_srcnn_precision)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--detector", choices=("dsgn", "srcnn"), default="dsgn")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--depth_dir", default=None,
                   help="dsgn: depth gt .npy dir (cli.make_depth_gt); "
                        "without it only the detection losses train")
    p.add_argument("--ckpt_dir", default=None,
                   help="default: {detector}_ckpts")
    p.add_argument("--ckpt_every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest epochN checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    add_device_args(p)
    return p.parse_args(argv)


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int):
    """`optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`: the learning rate at update count n, rising linearly
    from 0 over the warmup, then falling as a half cosine to 0 at
    `decay_steps` (warmup included) and staying there."""
    def sched(n: int) -> float:
        if n < warmup_steps:
            return peak * n / warmup_steps
        span = decay_steps - warmup_steps
        t = min(n - warmup_steps, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))
    return sched


class DetectorOptimizer:
    """The optax chain of the JAX trainer, step for step: every gradient
    is scaled by min(1, max_norm / global norm), the norm taken over all
    of them (the frozen statistics' included); `adamw` then updates the
    parameters it holds at the learning rate `sched(count)`, read before
    the count advances, so the first update has the schedule's first
    value. Parameters outside `adamw` are never written."""

    def __init__(self, adamw: torch.optim.AdamW, clipped, sched,
                 max_norm: float = 10.0):
        self.adamw, self.clipped = adamw, list(clipped)
        self.sched, self.max_norm = sched, max_norm
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.clipped:
            p.grad = None

    def step(self) -> None:
        grads = [p.grad for p in self.clipped if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        torch._foreach_mul_(grads, torch.clamp(self.max_norm / norm, max=1.0))
        lr = self.sched(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_detector_optimizer(named_params, sched) -> DetectorOptimizer:
    """adamw (decoupled decay 1e-4) over the network weights, plain adam
    (no decay) over an `uncert` vector, and hard-frozen FrozenBatchNorm
    statistics (`mean`, `var`): the masks of the JAX trainer. The
    statistics are ordinary parameters (models/common.py); decay would
    drag `var` toward 0 and rsqrt(var + eps) toward NaN. Their gradients
    still count in the clip's global norm, as in the optax chain."""
    net, uncert, clipped = [], [], []
    for name, p in named_params:
        keys = name.split(".")
        clipped.append(p)
        if keys[0] == "uncert":
            uncert.append(p)
        elif keys[-1] not in ("mean", "var"):
            net.append(p)
    groups = [{"params": net, "weight_decay": 1e-4}]
    if uncert:
        groups.append({"params": uncert, "weight_decay": 0.0})
    adamw = torch.optim.AdamW(groups, lr=sched(0), betas=(0.9, 0.999),
                              eps=1e-8)
    return DetectorOptimizer(adamw, clipped, sched)


def _pruned(tree):
    """A moment tree without the None leaves where an optax mask left a
    leaf out, nor the dicts that leaves empty."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _pruned(v) for k, v in tree.items() if v is not None}
    return {k: v for k, v in out.items()
            if not (isinstance(v, dict) and not v)}


def detector_state_from_optax(opt: DetectorOptimizer, named_params,
                              opt_state, moments) -> dict:
    """The `opt.state_dict()` that continues the JAX trainer's optax state
    `opt_state` (as utils.orbax_read reads it) step for step. The chain
    (JAX cli/train_detector.py make_detector_optimizer) is
    clip_by_global_norm (no state), adamw masked to the network weights,
    adam masked to `uncert`, set_to_zero masked to the frozen statistics:
    [None, {inner_state: [{count, mu, nu}, None, {count}]},
    {inner_state: [{count, mu, nu}, {count}]}, {inner_state: None}], mu
    and nu None where a mask leaves a leaf out. `moments(tree)` maps a
    moment tree to the port's parameter names and layouts, as the
    parameters are mapped; each AdamW parameter takes its moments and its
    transform's count as its step, and the schedule its count. Raises
    ValueError where the state is not that chain's for these
    parameters."""
    try:
        adamw = opt_state[1]["inner_state"][0]
        adam = opt_state[2]["inner_state"][0]
        src = {True: (adam, moments(_pruned(adam["mu"])),
                      moments(_pruned(adam["nu"]))),
               False: (adamw, moments(_pruned(adamw["mu"])),
                       moments(_pruned(adamw["nu"])))}
    except (TypeError, KeyError, IndexError) as e:
        raise ValueError("not the optax state of the JAX detector "
                         f"trainer's chain ({e!r})") from None
    names = {id(p): n for n, p in named_params}
    sd = opt.state_dict()
    state, i, used = {}, 0, set()
    for group in opt.adamw.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            counts, mu, nu = src[name == "uncert"]
            if name not in mu or name not in nu or \
                    tuple(mu[name].shape) != tuple(p.shape) or \
                    tuple(nu[name].shape) != tuple(p.shape):
                raise ValueError(f"the optax state has no moments of "
                                 f"{name} {tuple(p.shape)}")
            state[i] = {"step": torch.tensor(float(counts["count"])),
                        "exp_avg": torch.as_tensor(mu[name]),
                        "exp_avg_sq": torch.as_tensor(nu[name])}
            used.add(name)
            i += 1
    extra = (set(src[False][1]) | set(src[True][1])) - used
    if extra:
        raise ValueError(f"the optax state has moments of {sorted(extra)[:4]}"
                         ", which the optimizer does not update")
    sd["adamw"]["state"] = state
    sd["count"] = int(adamw["count"])
    return sd


def resume(path: str, model, opt: DetectorOptimizer, from_flax,
           uncert=None) -> int:
    """Load the epoch directory `path` into `model`, `opt` and `uncert`
    (Stereo R-CNN's loss weights) and return its epoch: the port's
    checkpoint, or the JAX trainer's orbax one, whose parameters (and
    moments) `from_flax` maps to the port's state dict."""
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        read_trainer_checkpoint
    ck, from_orbax = read_trainer_checkpoint(path)
    if from_orbax:
        def moments(tree):
            out = from_flax(tree.get("params", {}))
            if "uncert" in tree:
                out["uncert"] = torch.as_tensor(tree["uncert"])
            return out
        params = from_flax(ck["params"])
        named = list(model.named_parameters())
        if uncert is not None:
            named.append(("uncert", uncert))
        state = detector_state_from_optax(opt, named, ck["opt_state"],
                                          moments)
    else:
        params, state = ck["params"], ck["opt_state"]
    model.load_state_dict(params)
    if uncert is not None:
        with torch.no_grad():
            uncert.copy_(torch.as_tensor(ck["uncert"]))
    opt.load_state_dict(state)
    return int(ck["epoch"])


def make_train_step(model, opt: DetectorOptimizer, cfg, device):
    """One training step on a batch: u8 frames in, the loss out (a
    tensor on the device; reading it waits for the step)."""
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    mean = torch.tensor(cfg.input.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.input.std, dtype=torch.float32, device=device)

    def train_step(il_u8, ir_u8, calib, depth, boxes3d, num_boxes):
        out = model((u8_to_01(il_u8) - mean) / std,
                    (u8_to_01(ir_u8) - mean) / std, *calib)
        total, _ = dsgn_total_loss(out, depth, boxes3d, num_boxes, cfg)
        opt.zero_grad()
        total.backward()
        opt.step()
        return total.detach()
    return train_step


def run_dsgn(args):
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.data.dataset import (
        dsgn_boxes3d, prepare_dsgn_batch_u8)
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.utils.checkpoint import (
        latest_epoch_dir, save_checkpoint)
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        dsgn_state_dict_from_flax
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = DSGNConfig.tiny() if args.tiny else DSGNConfig()
    model = DSGN(cfg).init_weights(args.seed).to(device)
    ds = make_dataset(args)
    ckpt_dir = args.ckpt_dir or "dsgn_ckpts"
    sched = warmup_cosine_decay(
        args.lr, args.warmup_steps,
        max(args.epochs * max(len(ds) // args.batch, 1),
            args.warmup_steps + 1))
    opt = make_detector_optimizer(model.named_parameters(), sched)
    start_epoch = 0
    if args.resume:
        newest = latest_epoch_dir(ckpt_dir)
        if newest:
            start_epoch = resume(newest, model, opt,
                                 dsgn_state_dict_from_flax)
            log(f"resumed from {newest} (epoch {start_epoch})")
    train_step = make_train_step(model, opt, cfg, device)

    def prep(samples):
        return (prepare_dsgn_batch_u8(samples, cfg.input,
                                      depth_dir=args.depth_dir),
                dsgn_boxes3d(samples))

    def put(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(device)

    for epoch in range(args.epochs):
        losses = []
        for b, g in ds.batches(args.batch, drop_remainder=True,
                               prepare=prep):
            calib = tuple(put(b[k]) for k in ("f_u", "baseline", "c_u",
                                               "c_v"))
            losses.append(train_step(
                put(b["im_left_u8"]), put(b["im_right_u8"]), calib,
                put(b["depth_gt"]), put(g["boxes3d"]),
                put(g["num_boxes"], torch.int64)))
        e = start_epoch + epoch + 1
        mean_loss = float(torch.stack(losses).mean()) if losses else \
            float("nan")
        log(f"epoch {e}: loss {mean_loss:.4f}")
        if e % args.ckpt_every == 0 or epoch == args.epochs - 1:
            path = os.path.join(ckpt_dir, f"epoch{e}")
            save_checkpoint(path, {"params": model.state_dict(),
                                   "opt_state": opt.state_dict(),
                                   "epoch": e})
            log(f"  checkpoint -> {path}")


def make_srcnn_train_step(model, uncert, opt: DetectorOptimizer, cfg,
                          device):
    """One Stereo R-CNN training step: u8 frames and the batch's ingest
    weights (`prepare_srcnn_batch_u8`, on the device), the gt dict and the
    samplers' draws in; the total loss and the six terms out (tensors on
    the device)."""
    from eval_driving_safety_tpu_torch.data.dataset import \
        srcnn_clean01_device
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import \
        total_attack_loss
    means = torch.tensor(cfg.input.pixel_means_bgr, dtype=torch.float32,
                         device=device)

    def train_step(il_u8, ir_u8, weights, gt, draws):
        il = srcnn_clean01_device(weights, il_u8) * 255.0 - means
        ir = srcnn_clean01_device(weights, ir_u8) * 255.0 - means
        out = model(il, ir, gt=gt, draws=draws, mode="attack")
        total = total_attack_loss(out.losses, uncert)
        opt.zero_grad()
        total.backward()
        opt.step()
        return total.detach(), {k: v.detach() for k, v in out.losses.items()}
    return train_step


def run_srcnn(args):
    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    from eval_driving_safety_tpu_torch.data.dataset import \
        prepare_srcnn_batch_u8
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, make_gt_batch)
    from eval_driving_safety_tpu_torch.utils.checkpoint import (
        latest_epoch_dir, save_checkpoint)
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        stereo_rcnn_state_dict_from_flax
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = StereoRCNNConfig.tiny() if args.tiny else StereoRCNNConfig()
    use_srcnn_precision(cfg)
    model = StereoRCNN(cfg).init_weights(args.seed).to(device)
    uncert = torch.nn.Parameter(torch.zeros(6, device=device))
    ds = make_dataset(args)
    ckpt_dir = args.ckpt_dir or "srcnn_ckpts"
    sched = warmup_cosine_decay(
        args.lr, args.warmup_steps,
        max(args.epochs * max(len(ds) // args.batch, 1),
            args.warmup_steps + 1))
    opt = make_detector_optimizer(
        [*model.named_parameters(), ("uncert", uncert)], sched)
    start_epoch = 0
    if args.resume:
        newest = latest_epoch_dir(ckpt_dir)
        if newest:
            start_epoch = resume(
                newest, model, opt,
                lambda t: stereo_rcnn_state_dict_from_flax(t, model),
                uncert)
            log(f"resumed from {newest} (epoch {start_epoch})")
    train_step = make_srcnn_train_step(model, uncert, opt, cfg, device)
    # fresh draws at every step, as the JAX trainer splits its key
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    def prep(samples):
        b = prepare_srcnn_batch_u8(samples, cfg.input)
        return b, make_gt_batch(b["objects"], b["calibs"], cfg,
                                image_scale=b["scales"])

    def put(x):
        return torch.as_tensor(x).to(device)

    for epoch in range(args.epochs):
        losses = []
        for b, gt in ds.batches(args.batch, drop_remainder=True,
                                prepare=prep):
            weights = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                              "wmask", "c")}
            total, _ = train_step(
                put(b["im_left_u8"]), put(b["im_right_u8"]), weights,
                {k: v.to(device) for k, v in gt.items()},
                model.sample_draws(len(b["frame_ids"]), gen))
            losses.append(total)
        e = start_epoch + epoch + 1
        mean_loss = float(torch.stack(losses).mean()) if losses else \
            float("nan")
        log(f"epoch {e}: loss {mean_loss:.4f} uncert "
            f"{np.round(uncert.detach().cpu().numpy(), 3).tolist()}")
        if e % args.ckpt_every == 0 or epoch == args.epochs - 1:
            path = os.path.join(ckpt_dir, f"epoch{e}")
            save_checkpoint(path, {"params": model.state_dict(),
                                   "uncert": uncert.detach(),
                                   "opt_state": opt.state_dict(),
                                   "epoch": e})
            log(f"  checkpoint -> {path}")


def main(argv=None):
    args = parse_args(argv)
    (run_dsgn if args.detector == "dsgn" else run_srcnn)(args)


if __name__ == "__main__":
    main()
