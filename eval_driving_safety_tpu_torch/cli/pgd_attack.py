"""PGD attack sweep on DSGN or Stereo R-CNN, on one CUDA card.

Counterpart of `eval_driving_safety_tpu.cli.pgd_attack`, with the same
flags and the same output layout: every iteration's pair is saved as
`{prefix}_iters_{k}/image_{2,3}/<id>.png` (k = 0 is clean). Frames go to
the card as raw uint8, and with `--transfer signs` only 1- or 2-bit
packed gradient signs come back, from which the host replays every
iterate bit-exactly.

DSGN attacks in 255-space (clean = the exact pixels as f32, unit step,
ball 76.5 = 0.3 * 255). Stereo R-CNN attacks in v-space, the integer
scale of the exact resize to 600 rows (clean = den_h * den_w * 255 *
bgr01, data.exact_resize), with --alpha/--eps in BGR pixel units scaled
per frame by den_h * den_w. Both replay natively on the doubled integer
grid (attack.replay_native) where it is exact (attack.pgd.replay_255_valid,
srcnn_replay_intable), else in f32, and write stored-mode PNGs natively.

Under `torchrun --nproc_per_node N` every rank walks the same global
batches and splits each over the ranks (parallel.sharding): a batch whose
size divides by N is split into blocks of rows, every rank preparing the
global batch (its padding, the samplers' draws) and taking its rows, the
loss's normalizers summed over the ranks; each rank replays and writes
its own frames. Any other batch (a short last one) is computed whole by
every rank and written by rank 0. The files are those of one process.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.pgd_attack --detector dsgn \\
      --data_path KITTI/object/training --split_file val.txt \\
      --iter 4 --batch 1 --scale paper
  python -m eval_driving_safety_tpu_torch.cli.pgd_attack --detector srcnn \\
      --data_path KITTI/object/training --split_file val.txt --iter 4
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import os

import numpy as np
import torch

from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, add_io_args, add_scale_args, log,
    make_dataset, make_dsgn_cfg, make_dsgn_model, make_srcnn_cfg,
    make_srcnn_model, make_writer, process_group, use_deterministic_kernels,
    use_srcnn_precision)
from eval_driving_safety_tpu_torch.parallel.sharding import (
    barrier, dp_sharding, global_sum, shard_batch)

# queued replay jobs: each pins a packed trajectory and a host batch
_MAX_PENDING_REPLAYS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--detector", choices=("dsgn", "srcnn"), default="dsgn")
    p.add_argument("--iter", type=int, default=4)
    p.add_argument("--alpha", type=float, default=None,
                   help="step: dsgn in [0,1] units (default 1/255), srcnn "
                        "in BGR pixel units (default 1.0)")
    p.add_argument("--eps", type=float, default=None,
                   help="L-inf ball: dsgn in [0,1] units (default 0.3), "
                        "srcnn in BGR pixel units (default 255 * 0.3)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--depth_dir", default=None,
                   help="per-frame depth .npy ground truth for the "
                        "disparity loss (optional)")
    p.add_argument("--out_prefix", default=None,
                   help="default: dsgn_pgd, stereo_rcnn_pgd")
    p.add_argument("--fp32", action="store_true",
                   help="srcnn: f32 trunk with TF32 off (the attack's "
                        "default is a bf16 trunk)")
    p.add_argument("--bf16", action="store_true",
                   help="srcnn: bf16 trunk (already the attack's default)")
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose last-iteration outputs exist")
    p.add_argument("--debug_nans", action="store_true",
                   help="run autograd in anomaly-detection mode")
    p.add_argument("--transfer", choices=("signs", "full"), default="signs",
                   help="'signs': fetch packed gradient signs and replay on "
                        "the host (default); 'full': fetch the iterates "
                        "quantized to uint8 on the card")
    p.add_argument("--objective", default="total",
                   choices=("total", "depth_divergence", "depth_shift"))
    p.add_argument("--depth_shift_m", type=float, default=10.0)
    add_scale_args(p)
    add_io_args(p)
    add_device_args(p)
    return p.parse_args(argv)


def _already_done(prefix: str, n_iters: int, frame_ids) -> bool:
    return all(os.path.exists(os.path.join(
        f"{prefix}_iters_{n_iters}", "image_2", fid + ".png"))
        for fid in frame_ids)


def _done_batches(args, ds, prefix: str) -> set:
    """The batches (tuples of frame ids) that --resume skips: those whose
    last-iteration outputs all exist. Every rank decides on the same
    global batches before any rank writes (the caller waits at a
    barrier), so every rank skips the same ones."""
    if not args.resume:
        return set()
    chunks = (tuple(ds.ids[s:s + args.batch])
              for s in range(0, len(ds), args.batch))
    return {ids for ids in chunks if _already_done(prefix, args.iter, ids)}


def run_dsgn(args, mesh):
    from eval_driving_safety_tpu_torch.attack import objectives as O
    from eval_driving_safety_tpu_torch.attack.pgd import pgd_attack
    from eval_driving_safety_tpu_torch.data.dataset import (
        dsgn_boxes3d, prepare_dsgn_batch_u8, save_attacked_images,
        save_sweep_from_signs)
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = make_dsgn_cfg(args)
    model = make_dsgn_model(args, cfg, device)
    # 255-space: --alpha/--eps stay in the reference's [0,1] units
    alpha = np.float32(1.0) if args.alpha is None \
        else np.float32(args.alpha * 255.0)
    eps = np.float32(76.5) if args.eps is None \
        else np.float32(args.eps * 255.0)
    kw = dict(alpha=alpha, eps=eps, clip_min=0.0, clip_max=255.0)
    prefix = args.out_prefix or "dsgn_pgd"
    signs = args.transfer == "signs"
    ds = make_dataset(args)
    mean255 = torch.tensor(np.asarray(cfg.input.mean) * 255.0,
                           dtype=torch.float32, device=device)
    std255 = torch.tensor(np.asarray(cfg.input.std) * 255.0,
                          dtype=torch.float32, device=device)

    def attack(il_u8, ir_u8, calib, depth_gt, boxes3d, num_boxes):
        def loss_fn(il255, ir255):
            out = model((il255 - mean255) / std255,
                        (ir255 - mean255) / std255, *calib)
            if args.objective == "depth_divergence":
                return O.depth_divergence(out, depth_gt, cfg)
            if args.objective == "depth_shift":
                return O.depth_shift(out, depth_gt, args.depth_shift_m, cfg)
            return O.total_loss(out, depth_gt, boxes3d, num_boxes, cfg)

        # 1-bit planes need W*3 divisible by 8; else the 2-bit codes
        b1_ok = (il_u8.shape[-2] * il_u8.shape[-1]) % 8 == 0
        res = pgd_attack(loss_fn, il_u8.float(), ir_u8.float(),
                         num_iters=args.iter,
                         collect=(("signs1" if b1_ok else "signs")
                                  if signs else True), **kw)
        if signs:
            return res.losses, res.trajectory
        # truncation, the rule of the host replay: same PNGs either way
        return res.losses, tuple(t.to(torch.uint8) for t in res.trajectory)

    writer = make_writer(args)
    replayer = cf.ThreadPoolExecutor(max_workers=2) if signs else None
    pending = []

    def submit_replay(b, pl, pr):
        def job():
            save_sweep_from_signs(b, b["im_left_u8"], b["im_right_u8"],
                                  pl, pr, prefix, writer, **kw)
        if len(pending) >= _MAX_PENDING_REPLAYS:
            pending.pop(0).result()
        pending.append(replayer.submit(job))

    done = _done_batches(args, ds, prefix)
    barrier()

    def prep(samples):
        if tuple(s.frame_id for s in samples) in done:
            return None
        return (prepare_dsgn_batch_u8(samples, cfg.input,
                                      depth_dir=args.depth_dir),
                dsgn_boxes3d(samples))

    def put(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)

    try:
        for prepared in ds.batches(args.batch, prefetch=args.prefetch,
                                   io_workers=args.io_workers,
                                   prepare=prep):
            if prepared is None:                   # --resume skip
                continue
            # every rank prepares the global batch and takes its rows
            b, g = prepared
            ids = b["frame_ids"]
            sharding = dp_sharding(mesh, len(ids))
            b, g = shard_batch((b, g), sharding)
            calib = tuple(put(b[k]) for k in ("f_u", "baseline", "c_u",
                                               "c_v"))
            depth = torch.zeros(b["depth_gt"].shape, device=device) \
                if args.depth_dir is None else put(b["depth_gt"])
            with sharding:
                losses, traj = attack(
                    put(b["im_left_u8"]), put(b["im_right_u8"]), calib,
                    depth, put(g["boxes3d"]), put(g["num_boxes"],
                                                  torch.int64))
                losses = global_sum(losses)
            if signs and sharding.writes:
                submit_replay(b, traj[0], traj[1])
            elif sharding.writes:
                save_attacked_images(b, b["im_left_u8"], b["im_right_u8"],
                                     f"{prefix}_iters_0", writer=writer)
                for k in range(args.iter):
                    save_attacked_images(b, traj[0][k], traj[1][k],
                                         f"{prefix}_iters_{k + 1}",
                                         writer=writer)
            log(f"{ids}: losses "
                f"{np.round(losses.cpu().numpy(), 3).tolist()}")
    finally:
        for f in pending:
            f.result()
        if replayer is not None:
            replayer.shutdown()
        if writer is not None:
            writer.close()


# the samplers' draws: the same every iteration and every batch, as the
# JAX CLI's one sampling key
SRCNN_DRAW_SEED = 11


def run_srcnn(args, mesh):
    from eval_driving_safety_tpu_torch.attack.pgd import (
        pgd_attack, replay_pgd, signs1_to_packed2, srcnn_replay_intable)
    from eval_driving_safety_tpu_torch.attack import replay_native
    from eval_driving_safety_tpu_torch.data.dataset import (
        fetch_packed_signs, prepare_srcnn_batch_u8, quantize_v_rgb_u8,
        save_sweep, srcnn_cleanv_device, srcnn_cleanv_q0_host)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        make_gt_batch, total_attack_loss)
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = make_srcnn_cfg(args, default_bf16=True, default_s2d=True)
    use_srcnn_precision(cfg)
    model, uncert = make_srcnn_model(args, cfg, device)
    a_pix = 1.0 if args.alpha is None else args.alpha
    e_pix = 255.0 * 0.3 if args.eps is None else args.eps
    prefix = args.out_prefix or "stereo_rcnn_pgd"
    signs = args.transfer == "signs"
    ds = make_dataset(args)
    means = torch.tensor(cfg.input.pixel_means_bgr, dtype=torch.float32,
                         device=device)

    def attack(il_u8, ir_u8, weights, gt, draws, alpha_v, eps_v, max_v,
               c255):
        clean_l = srcnn_cleanv_device(weights, il_u8)
        clean_r = srcnn_cleanv_device(weights, ir_u8)
        cb = c255[:, None, None, None]

        def loss_fn(il_v, ir_v):
            out = model(il_v * cb - means, ir_v * cb - means, gt=gt,
                        draws=draws, mode="attack")
            return total_attack_loss(out.losses, uncert)

        b1_ok = (clean_l.shape[-2] * clean_l.shape[-1]) % 8 == 0
        res = pgd_attack(loss_fn, clean_l, clean_r, num_iters=args.iter,
                         alpha=alpha_v, eps=eps_v, clip_min=0.0,
                         clip_max=max_v,
                         collect=(("signs1" if b1_ok else "signs")
                                  if signs else True))
        if signs:
            return res.losses, res.trajectory
        # quantized on the card by the host replay's operations
        return res.losses, tuple(quantize_v_rgb_u8(t, c255)
                                 for t in res.trajectory)

    writer = make_writer(args)
    replayer = cf.ThreadPoolExecutor(max_workers=2)
    pending = []
    logged = False

    def replay_job(b, pl, pr, K, vkw, intable):
        v2l, v2r, q0l, q0r = srcnn_cleanv_q0_host(b)
        c255 = b["c255"]
        pl, pr, bits = fetch_packed_signs(pl, pr)
        if intable:
            p2 = dict(alpha2=np.rint(2.0 * a_pix * K).astype(np.int64),
                      eps2=np.rint(2.0 * e_pix * K).astype(np.int64),
                      max2=(510 * K).astype(np.int64), c255=c255,
                      flip_channels=True, bits=bits)
            frames = zip(replay_native.replay_sweep_u8(v2l, pl, **p2),
                         replay_native.replay_sweep_u8(v2r, pr, **p2))
        else:
            if bits == 1:
                pl, pr = signs1_to_packed2(pl), signs1_to_packed2(pr)
            frames = ((quantize_v_rgb_u8(a, c255), quantize_v_rgb_u8(c, c255))
                      for a, c in replay_pgd(
                          v2l.astype(np.float32), v2r.astype(np.float32),
                          pl, pr, **vkw))
        save_sweep(b, (q0l, q0r), frames, prefix, writer)

    done = _done_batches(args, ds, prefix)
    barrier()

    def prep(samples):
        if tuple(s.frame_id for s in samples) in done:
            return None
        # the global batch: its frames are padded to its largest
        b = prepare_srcnn_batch_u8(samples, cfg.input)
        gt = make_gt_batch(b["objects"], b["calibs"], cfg,
                           image_scale=b["scales"])
        K = b["den_h"].astype(np.float64) * b["den_w"]
        vkw = {k: (v * K).astype(np.float32).reshape(-1, 1, 1, 1)
               for k, v in (("alpha", a_pix), ("eps", e_pix),
                            ("clip_max", 255.0))}
        return b, gt, K, dict(vkw, clip_min=0.0)

    def put(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    try:
        for prepared in ds.batches(args.batch, prefetch=args.prefetch,
                                   io_workers=args.io_workers,
                                   prepare=prep):
            if prepared is None:                   # --resume skip
                continue
            b, gt, K, vkw = prepared
            ids = b["frame_ids"]
            sharding = dp_sharding(mesh, len(ids))
            # decided, and drawn, for the global batch; then its rows
            intable = srcnn_replay_intable(a_pix, e_pix, K)
            draws = model.sample_draws(len(ids), torch.Generator(
                device=device).manual_seed(SRCNN_DRAW_SEED))
            b, gt, K, vkw, draws = shard_batch((b, gt, K, vkw, draws),
                                               sharding)
            weights = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                              "wmask")}
            with sharding:
                losses, traj = attack(
                    put(b["im_left_u8"]), put(b["im_right_u8"]), weights,
                    {k: v.to(device) for k, v in gt.items()}, draws,
                    put(vkw["alpha"]), put(vkw["eps"]),
                    put(vkw["clip_max"]), put(b["c255"]))
                losses = global_sum(losses)
            if signs and sharding.writes:
                if not logged:
                    logged = True
                    log("host replay path: " + (
                        "native/int (bit-exact integer grid)" if intable
                        else "f32 per-iteration (alpha/eps off the integer "
                        "grid or values past the f32-exact bound)"))
                if len(pending) >= _MAX_PENDING_REPLAYS:
                    pending.pop(0).result()
                pending.append(replayer.submit(replay_job, b, traj[0],
                                               traj[1], K, vkw, intable))
            elif sharding.writes:
                _, _, q0l, q0r = srcnn_cleanv_q0_host(b)
                save_sweep(b, (q0l, q0r), zip(traj[0], traj[1]), prefix,
                           writer)
            log(f"{ids}: losses "
                f"{np.round(losses.cpu().numpy(), 3).tolist()}")
    finally:
        for f in pending:
            f.result()
        replayer.shutdown()
        if writer is not None:
            writer.close()


def main(argv=None):
    args = parse_args(argv)
    with process_group(args) as mesh, \
            torch.autograd.set_detect_anomaly(args.debug_nans):
        (run_dsgn if args.detector == "dsgn" else run_srcnn)(args, mesh)


if __name__ == "__main__":
    main()
