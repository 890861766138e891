"""Universal-patch training on one CUDA card: DSGN and Stereo R-CNN.

Counterpart of `eval_driving_safety_tpu.cli.patch_attack`, with the
same flags, defaults and output layout: a circular patch is trained over
the split for N epochs toward targeted labels, composited into both
views (the right view's centre shifted by the stereo disparity offset),
and saved after each epoch as `{save_dir}/epoch{N}/patch.npy` in the
reference's (1, 3, d, d) layout; `{save_dir}/epoch0/patch.npy` is the
start, zeros or a patch left there to resume from. The detector's
weights are frozen: every step computes the loss and its gradient with
respect to the patch only.

DSGN (defaults: ratio 0.2, eps 8/255, 80 epochs): the patch lives in
[0,1] RGB and descends the loss toward a ghost car. Stereo R-CNN
(StereoRCNNConfig(), bf16 unless `--fp32`; ratio 0.1, eps 0.1, 40
epochs): the patch lives in the network's input space, BGR pixels minus
the means, clamped per channel to the pixel range; the only gt object
is the patch's own box at the centres of the composite; the samplers'
draws come from one generator seed (17), the same at every step, and a
checkpoint's `uncert` weights the six loss terms.

Frames go to the card as raw uint8 in the first epoch and, up to 2 GiB
of them, stay there for the later epochs, which upload nothing; the
card converts them (Stereo R-CNN: its exact integer resize to 600 rows)
at every visit of a batch. Centres are drawn from a `torch.Generator`
seeded by (seed, epoch, batch): the same flags give the same patches,
though not the JAX CLI's draws.

Under `torchrun --nproc_per_node N` a batch whose size divides by N is
split over the ranks (parallel.sharding): each rank prepares the global
batch, takes its rows of it, of its centres and of the samplers' draws,
and caches only those; the loss's normalizers, the patch gradient and the
epoch's loss are the global batch's, so every rank holds the patch of one
process, which rank 0 writes. Other batch sizes run whole on every rank.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.patch_attack --detector dsgn \\
      --data_path KITTI/object/training --split_file train.txt \\
      --epochs 80 --iters 2 --batch 1 --scale paper
  python -m eval_driving_safety_tpu_torch.cli.patch_attack --detector srcnn \\
      --data_path KITTI/object/training --split_file train.txt
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from eval_driving_safety_tpu_torch.attack.patch import (
    init_patch, patch_update_step, sample_patch_centers, save_patch)
from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, add_scale_args, log, make_dataset,
    make_dsgn_cfg, make_dsgn_model, make_srcnn_cfg, make_srcnn_model,
    process_group, use_deterministic_kernels, use_srcnn_precision)
from eval_driving_safety_tpu_torch.config import PatchConfig
from eval_driving_safety_tpu_torch.parallel.sharding import (
    dp_sharding, rank_zero_first, shard_batch)

# the most bytes of u8 frames the epoch cache keeps on the card
_CACHE_LIMIT = 2 << 30


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--detector", choices=("dsgn", "srcnn"), default="dsgn")
    p.add_argument("--ratio", type=float, default=None,
                   help="patch diameter / image short side "
                        "(default 0.2 dsgn, 0.1 srcnn)")
    p.add_argument("--eps", type=float, default=None,
                   help="per-step clamp (default 8/255 dsgn, 0.1 srcnn)")
    p.add_argument("--alpha", type=float, default=1e3)
    p.add_argument("--iters", type=int, default=2, help="iters per batch")
    p.add_argument("--epochs", type=int, default=None,
                   help="default 80 dsgn / 40 srcnn")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save_dir", default=None,
                   help="default {detector}_patch_ratio_{ratio}")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the patch placements")
    p.add_argument("--fp32", action="store_true",
                   help="float32 trunk for the srcnn detector, with TF32 "
                        "off")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 trunk for the srcnn detector (already "
                        "its default; DSGN takes its dtype from the "
                        "config)")
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


def train_patch(args, mesh, ds, patch, save_dir, epochs, frame_bytes,
                upload, batch_steps):
    """The epoch loop of both detectors: each batch of `ds` is split over
    the ranks (`parallel.sharding.dp_sharding`), its rows uploaded
    (`upload(samples, sharding)` -> a dict of device tensors) and, while
    the split's frames take at most `_CACHE_LIMIT` bytes (`frame_bytes`
    each), kept on the card for the later epochs;
    `batch_steps(patch, item, sharding, gen)` runs the batch's --iters
    steps with the centres `gen` draws for the global batch and returns
    (patch, the global batch's last loss). The patch, the same on every
    rank, is saved by rank 0 after every epoch."""
    est = len(ds) * frame_bytes
    use_cache = est <= _CACHE_LIMIT
    if not use_cache:
        log(f"epoch cache disabled (~{est >> 20} MiB of frames)")

    def uploads():
        for samples in ds.batches(args.batch, drop_remainder=True):
            sharding = dp_sharding(mesh, len(samples))
            yield sharding, upload(samples, sharding)
    cache = []
    for epoch in range(epochs):
        source = cache if use_cache and epoch > 0 else uploads()
        epoch_losses = []
        for bi, (sharding, item) in enumerate(source):
            if use_cache and epoch == 0:
                cache.append((sharding, item))
            with sharding:
                patch, loss = batch_steps(
                    patch, item, sharding,
                    batch_generator(args.seed, epoch, bi))
            epoch_losses.append(float(loss))
        log(f"epoch {epoch + 1}/{epochs}: avg loss "
            f"{np.mean(epoch_losses):.4f}")
        if mesh.rank == 0:
            save_patch(os.path.join(save_dir, f"epoch{epoch + 1}",
                                    "patch.npy"), patch)
    return patch


def run_dsgn(args, mesh):
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

    with rank_zero_first(mesh):
        dim, radius, patch = init_patch(cfg.height, ratio, save_dir)
    log(f"patch dim {dim} (radius {radius}); save_dir {save_dir}")

    def upload(samples, sharding):
        b = prepare_dsgn_batch_u8(samples, cfg.input)
        put = lambda x: torch.as_tensor(x).to(device, non_blocking=True)
        b, (boxes, num) = shard_batch(
            (b, ghost_car_targets(len(samples), pcfg)), sharding)
        return {"il": put(b["im_left_u8"]), "ir": put(b["im_right_u8"]),
                "calib": tuple(put(b[k]) for k in ("f_u", "baseline", "c_u",
                                                    "c_v")),
                "boxes": put(boxes), "num": put(num)}

    def batch_steps(patch, item, sharding, gen):
        il, ir = u8_to_01(item["il"]), u8_to_01(item["ir"])
        depth = torch.zeros(il.shape[:3], device=device)
        cl, cr = shard_batch(sample_patch_centers(
            gen, sharding.n, il.shape[1], il.shape[2], radius,
            row_band=pcfg.row_band, col_band=pcfg.col_band,
            disparity_shift=pcfg.disparity_shift), sharding)

        def loss_fn(il01, ir01):
            out = model((il01 - mean) / std, (ir01 - mean) / std,
                        *item["calib"])
            total, _ = dsgn_total_loss(out, depth, item["boxes"],
                                       item["num"], cfg)
            return total

        for _ in range(args.iters):
            patch, loss = patch_update_step(loss_fn, patch, il, ir, cl, cr,
                                            alpha=args.alpha, eps=eps)
        return patch, loss

    train_patch(args, mesh, ds, patch.to(device), save_dir, epochs,
                2 * 3 * cfg.input.height * cfg.input.width, upload,
                batch_steps)


# the Stereo R-CNN defaults (the JAX CLI's): a 60-px patch at 600 rows,
# 0.1 px per step, 40 epochs
SRCNN_RATIO, SRCNN_EPS, SRCNN_EPOCHS = 0.1, 0.1, 40
# the samplers' draws: the same at every step, as the JAX CLI's one key
SRCNN_PATCH_DRAW_SEED = 17
# bytes of one frame pair in the epoch cache's estimate: raw uint8 KITTI
# frames of up to 400 x 1300
SRCNN_FRAME_BYTES = 2 * 3 * 400 * 1300


def _srcnn_patch_targets(bsz, cfg, radius, cl, cr, device=None):
    """The Stereo R-CNN targets of a patch batch: the patch's own box,
    at the composite's centres `cl`/`cr` ((B, 2) rows and columns), is the
    only gt object of each image; a gt dict as `make_gt_batch` makes."""
    g = cfg.max_gt_boxes
    gl = np.zeros((bsz, g, 5), np.float32)
    gr = np.zeros((bsz, g, 5), np.float32)
    gm = np.zeros((bsz, g, 4), np.float32)
    gdo = np.zeros((bsz, g, 5), np.float32)
    gk = np.full((bsz, g, 6), -1.0, np.float32)
    cl = np.asarray(torch.as_tensor(cl).cpu())
    cr = np.asarray(torch.as_tensor(cr).cpu())
    for i in range(bsz):
        y, x = cl[i]
        xr = cr[i, 1]
        gl[i, 0] = [x - radius, y - radius, x + radius, y + radius, 1.0]
        gr[i, 0] = [xr - radius, y - radius, xr + radius, y + radius, 1.0]
        gm[i, 0] = [min(x, xr) - radius, y - radius,
                    max(x, xr) + radius, y + radius]
        gdo[i, 0] = [1.5, 1.6, 3.9, 0.0, 1.0]
        gk[i, 0] = [0.0, x, x - radius, x + radius, 0.0, 0.0]
    out = {"gt_left": gl, "gt_right": gr, "gt_merge": gm,
           "gt_dim_orien": gdo, "gt_kpts": gk,
           "num_boxes": np.ones((bsz,), np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def run_srcnn(args, mesh):
    from eval_driving_safety_tpu_torch.data.dataset import (
        prepare_srcnn_batch_u8, srcnn_clean01_device, srcnn_clip_bounds)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import \
        total_attack_loss
    pcfg = PatchConfig()
    ratio = SRCNN_RATIO if args.ratio is None else args.ratio
    eps = SRCNN_EPS if args.eps is None else args.eps
    epochs = SRCNN_EPOCHS if args.epochs is None else args.epochs
    save_dir = args.save_dir or f"{args.detector}_patch_ratio_{ratio}"
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = make_srcnn_cfg(args, default_bf16=True, default_s2d=True)
    use_srcnn_precision(cfg)
    model, uncert = make_srcnn_model(args, cfg, device)
    if uncert.any():
        log(f"using checkpoint uncert={np.round(uncert.tolist(), 3)}")
    means = torch.tensor(cfg.input.pixel_means_bgr, dtype=torch.float32,
                         device=device)
    # per-channel bounds of the patch in BGR pixels minus the means
    pix_min, pix_max = (torch.from_numpy(v).to(device)
                        for v in srcnn_clip_bounds(cfg.input))
    h, w = cfg.input.height, cfg.input.width
    ds = make_dataset(args)
    # every batch has --batch frames (the last, smaller one is dropped);
    # each rank takes its rows of the global batch's draws
    draws = model.sample_draws(args.batch, torch.Generator(
        device=device).manual_seed(SRCNN_PATCH_DRAW_SEED))

    with rank_zero_first(mesh):
        dim, radius, patch = init_patch(h, ratio, save_dir)
    log(f"patch dim {dim} (radius {radius}); save_dir {save_dir}")

    def upload(samples, sharding):
        # the global batch (its frames padded to its largest), then its rows
        b = shard_batch(prepare_srcnn_batch_u8(samples, cfg.input), sharding)
        put = lambda x: torch.as_tensor(x).to(device, non_blocking=True)
        return {"il": put(b["im_left_u8"]), "ir": put(b["im_right_u8"]),
                "weights": {k: put(b[k]) for k in ("ih", "iw", "den_h",
                                                   "den_w", "wmask", "c")}}

    def batch_steps(patch, item, sharding, gen):
        il = srcnn_clean01_device(item["weights"], item["il"]) * 255.0 \
            - means
        ir = srcnn_clean01_device(item["weights"], item["ir"]) * 255.0 \
            - means
        cl, cr = shard_batch(sample_patch_centers(
            gen, sharding.n, h, w, radius, row_band=pcfg.row_band,
            col_band=pcfg.col_band, disparity_shift=pcfg.disparity_shift),
            sharding)
        gt = _srcnn_patch_targets(il.shape[0], cfg, radius, cl, cr, device)
        rows_draws = shard_batch(draws, sharding)

        def loss_fn(left, right):
            out = model(left, right, gt=gt, draws=rows_draws, mode="attack")
            return total_attack_loss(out.losses, uncert)

        for _ in range(args.iters):
            patch, loss = patch_update_step(
                loss_fn, patch, il, ir, cl, cr, alpha=args.alpha, eps=eps,
                pixel_min=pix_min, pixel_max=pix_max)
        return patch, loss

    train_patch(args, mesh, ds, patch.to(device), save_dir, epochs,
                SRCNN_FRAME_BYTES, upload, batch_steps)


def main(argv=None):
    args = parse_args(argv)
    with process_group(args) as mesh:
        (run_dsgn if args.detector == "dsgn" else run_srcnn)(args, mesh)


if __name__ == "__main__":
    main()
