"""PGD attack sweep on DSGN, on one CUDA card.

Counterpart of `eval_driving_safety_tpu.cli.pgd_attack --detector dsgn`,
with the same flags and the same output layout: every iteration's pair
is saved as `{prefix}_iters_{k}/image_{2,3}/<id>.png` (k = 0 is clean).
Frames go to the card as raw uint8; the attack runs in 255-space (clean
= the exact pixels as f32, unit step, ball 76.5 = 0.3 * 255), so with
`--transfer signs` only 1- or 2-bit packed gradient signs come back and
the host replays every iterate bit-exactly in int16.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.pgd_attack --detector dsgn \\
      --data_path KITTI/object/training --split_file val.txt \\
      --iter 4 --batch 1 --scale paper
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import os

import numpy as np
import torch

from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, add_io_args, add_scale_args, log,
    make_dataset, make_dsgn_cfg, make_dsgn_model, make_writer,
    use_deterministic_kernels)

# queued replay jobs: each pins a packed trajectory and a host batch
_MAX_PENDING_REPLAYS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--detector", choices=("dsgn", "srcnn"), default="dsgn")
    p.add_argument("--iter", type=int, default=4)
    p.add_argument("--alpha", type=float, default=None,
                   help="step in [0,1] units (default 1/255)")
    p.add_argument("--eps", type=float, default=None,
                   help="L-inf ball in [0,1] units (default 0.3)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--depth_dir", default=None,
                   help="per-frame depth .npy ground truth for the "
                        "disparity loss (optional)")
    p.add_argument("--out_prefix", default=None,
                   help="default: dsgn_pgd")
    p.add_argument("--fp32", action="store_true",
                   help="Stereo R-CNN trunk dtype (not ported yet)")
    p.add_argument("--bf16", action="store_true",
                   help="Stereo R-CNN trunk dtype (not ported yet)")
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose last-iteration outputs exist")
    p.add_argument("--debug_nans", action="store_true",
                   help="run autograd in anomaly-detection mode")
    p.add_argument("--transfer", choices=("signs", "full"), default="signs",
                   help="'signs': fetch packed gradient signs and replay on "
                        "the host (default); 'full': fetch truncated "
                        "uint8 iterates")
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


def run_dsgn(args):
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

    def prep(samples):
        if args.resume and _already_done(prefix, args.iter,
                                         [s.frame_id for s in samples]):
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
            b, g = prepared
            calib = tuple(put(b[k]) for k in ("f_u", "baseline", "c_u",
                                               "c_v"))
            depth = torch.zeros(b["depth_gt"].shape, device=device) \
                if args.depth_dir is None else put(b["depth_gt"])
            losses, traj = attack(put(b["im_left_u8"]), put(b["im_right_u8"]),
                                  calib, depth, put(g["boxes3d"]),
                                  put(g["num_boxes"], torch.int64))
            if signs:
                submit_replay(b, traj[0], traj[1])
            else:
                save_attacked_images(b, b["im_left_u8"], b["im_right_u8"],
                                     f"{prefix}_iters_0", writer=writer)
                for k in range(args.iter):
                    save_attacked_images(b, traj[0][k], traj[1][k],
                                         f"{prefix}_iters_{k + 1}",
                                         writer=writer)
            log(f"{b['frame_ids']}: losses "
                f"{np.round(losses.cpu().numpy(), 3).tolist()}")
    finally:
        for f in pending:
            f.result()
        if replayer is not None:
            replayer.shutdown()
        if writer is not None:
            writer.close()


def main(argv=None):
    args = parse_args(argv)
    if args.detector == "srcnn":
        raise SystemExit("--detector srcnn is not ported yet: Stereo R-CNN "
                         "is ROADMAP item 9 (use eval_driving_safety_tpu "
                         "for it)")
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        run_dsgn(args)


if __name__ == "__main__":
    main()
