"""Universal-patch training on DSGN, on one CUDA card.

Counterpart of `eval_driving_safety_tpu.cli.patch_attack --detector
dsgn`, with the same flags and the same output layout: a circular patch
is trained over the split for N epochs toward the targeted ghost-car
labels, composited into both views (the right view's centre shifted by
the stereo disparity offset), and saved after each epoch as
`{save_dir}/epoch{N}/patch.npy` in the reference's (1, 3, d, d) layout;
`{save_dir}/epoch0/patch.npy` is the start, zeros or a patch left there
to resume from. The detector's weights are frozen: every step computes
the loss and its gradient with respect to the patch only.

Frames go to the card as raw uint8 in the first epoch and, up to 2 GiB
of them, stay there for the later epochs, which upload nothing. Centres
are drawn from a `torch.Generator` seeded by (seed, epoch, batch): the
same flags give the same patches, though not the JAX CLI's draws.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.patch_attack --detector dsgn \\
      --data_path KITTI/object/training --split_file train.txt \\
      --epochs 80 --iters 2 --batch 1 --scale paper
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, add_scale_args, log, make_dataset,
    make_dsgn_cfg, make_dsgn_model, use_deterministic_kernels)
from eval_driving_safety_tpu_torch.config import PatchConfig

# the most bytes of u8 frames the epoch cache keeps on the card
_CACHE_LIMIT = 2 << 30


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--detector", choices=("dsgn", "srcnn"), default="dsgn")
    p.add_argument("--ratio", type=float, default=None,
                   help="patch diameter / image short side (default 0.2)")
    p.add_argument("--eps", type=float, default=None,
                   help="per-step clamp (default 8/255)")
    p.add_argument("--alpha", type=float, default=1e3)
    p.add_argument("--iters", type=int, default=2, help="iters per batch")
    p.add_argument("--epochs", type=int, default=None,
                   help="default 80")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save_dir", default=None,
                   help="default {detector}_patch_ratio_{ratio}")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the patch placements")
    p.add_argument("--fp32", action="store_true",
                   help="Stereo R-CNN trunk dtype (not ported yet)")
    p.add_argument("--bf16", action="store_true",
                   help="Stereo R-CNN trunk dtype (not ported yet; DSGN "
                        "takes its dtype from the config)")
    add_scale_args(p)
    add_device_args(p)
    return p.parse_args(argv)


def ghost_car_targets(batch_size: int, pcfg: PatchConfig):
    """The targeted ghost car as (B, 16, 8) [x, y, z, h, w, l, ry, cls]
    rows, the car in row 0, and num_boxes of 1."""
    h, w, l, x, y, z, ry = pcfg.ghost_box3d
    boxes = np.zeros((batch_size, 16, 8), np.float32)
    boxes[:, 0] = [x, y, z, h, w, l, ry, 1.0]
    return torch.from_numpy(boxes), torch.ones(batch_size, dtype=torch.int64)


def batch_generator(seed: int, epoch: int, batch_index: int):
    """The generator of one batch's centres."""
    state = np.random.SeedSequence([seed, epoch, batch_index])
    return torch.Generator().manual_seed(int(state.generate_state(1)[0]))


def run_dsgn(args):
    from eval_driving_safety_tpu_torch.attack.patch import (
        init_patch, patch_update_step, sample_patch_centers, save_patch)
    from eval_driving_safety_tpu_torch.data.dataset import (
        prepare_dsgn_batch_u8, u8_to_01)
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    pcfg = PatchConfig()
    ratio = pcfg.ratio if args.ratio is None else args.ratio
    eps = pcfg.eps if args.eps is None else args.eps
    epochs = pcfg.epochs if args.epochs is None else args.epochs
    save_dir = args.save_dir or f"{args.detector}_patch_ratio_{ratio}"
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = make_dsgn_cfg(args)
    model = make_dsgn_model(args, cfg, device)
    mean = torch.tensor(cfg.input.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.input.std, dtype=torch.float32, device=device)
    ds = make_dataset(args)

    dim, radius, patch = init_patch(cfg.height, ratio, save_dir)
    patch = patch.to(device)
    log(f"patch dim {dim} (radius {radius}); save_dir {save_dir}")

    def upload(samples):
        b = prepare_dsgn_batch_u8(samples, cfg.input)
        put = lambda x: torch.as_tensor(x).to(device, non_blocking=True)
        boxes, num = ghost_car_targets(len(samples), pcfg)
        return {"il": put(b["im_left_u8"]), "ir": put(b["im_right_u8"]),
                "calib": tuple(put(b[k]) for k in ("f_u", "baseline", "c_u",
                                                    "c_v")),
                "boxes": put(boxes), "num": put(num)}

    # epoch cache: each batch's u8 frames and calibration stay on the
    # card after the first epoch, unless the split is too large
    est = len(ds) * 2 * 3 * cfg.input.height * cfg.input.width
    use_cache = est <= _CACHE_LIMIT
    if not use_cache:
        log(f"epoch cache disabled (~{est >> 20} MiB of frames)")
    cache = []

    for epoch in range(epochs):
        source = cache if use_cache and epoch > 0 else (
            upload(s) for s in ds.batches(args.batch, drop_remainder=True))
        epoch_losses = []
        for bi, item in enumerate(source):
            if use_cache and epoch == 0:
                cache.append(item)
            il, ir = u8_to_01(item["il"]), u8_to_01(item["ir"])
            depth = torch.zeros(il.shape[:3], device=device)
            cl, cr = sample_patch_centers(
                batch_generator(args.seed, epoch, bi), il.shape[0],
                il.shape[1], il.shape[2], radius, row_band=pcfg.row_band,
                col_band=pcfg.col_band,
                disparity_shift=pcfg.disparity_shift)

            def loss_fn(il01, ir01, item=item, depth=depth):
                out = model((il01 - mean) / std, (ir01 - mean) / std,
                            *item["calib"])
                total, _ = dsgn_total_loss(out, depth, item["boxes"],
                                           item["num"], cfg)
                return total

            for _ in range(args.iters):
                patch, loss = patch_update_step(loss_fn, patch, il, ir, cl,
                                                cr, alpha=args.alpha, eps=eps)
            epoch_losses.append(float(loss))
        log(f"epoch {epoch + 1}/{epochs}: avg loss "
            f"{np.mean(epoch_losses):.4f}")
        save_patch(os.path.join(save_dir, f"epoch{epoch + 1}", "patch.npy"),
                   patch)


def main(argv=None):
    args = parse_args(argv)
    if args.detector == "srcnn":
        raise SystemExit("--detector srcnn is not ported yet: the Stereo "
                         "R-CNN patch attack is ROADMAP item 11 (use "
                         "eval_driving_safety_tpu for it)")
    run_dsgn(args)


if __name__ == "__main__":
    main()
