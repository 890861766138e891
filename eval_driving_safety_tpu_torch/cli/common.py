"""Shared CLI plumbing: dataset and IO flags, DSGN config and weights."""
from __future__ import annotations

import argparse
import os


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--data_path", required=True,
                   help="KITTI object dir with image_2/image_3/calib/label_2")
    p.add_argument("--split_file", default=None,
                   help="txt with one frame id per line (e.g. val.txt)")
    p.add_argument("--image_2_dir", default=None,
                   help="override left-image dir (e.g. an attacked dir)")
    p.add_argument("--image_3_dir", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debugnum", type=int, default=2,
                   help="with --debug: use only the first N frames")


def make_dataset(args):
    from eval_driving_safety_tpu_torch.data.dataset import KittiStereoDataset
    ds = KittiStereoDataset(args.data_path, split_file=args.split_file,
                            image_2_dir=args.image_2_dir,
                            image_3_dir=args.image_3_dir)
    if args.debug:
        ds.ids = ds.ids[: args.debugnum]
    return ds


def add_io_args(p: argparse.ArgumentParser):
    """Host-IO overlap flags: prefetching loader + background PNG writer."""
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches of PNG decodes kept in flight ahead of "
                        "the device (0 = synchronous loads)")
    p.add_argument("--io_workers", type=int, default=4,
                   help="loader thread-pool size")
    p.add_argument("--png_level", type=int, default=0,
                   help="PNG zlib level of the written frames (0 = stored "
                        "blocks, fastest; pixels are identical at every "
                        "level)")
    p.add_argument("--sync_io", action="store_true",
                   help="write PNGs on the calling thread (debugging)")


def make_writer(args):
    """AsyncImageWriter from the IO flags, or None with --sync_io."""
    if args.sync_io:
        return None
    from eval_driving_safety_tpu_torch.data.dataset import AsyncImageWriter
    return AsyncImageWriter(compress_level=args.png_level)


def add_scale_args(p: argparse.ArgumentParser):
    """--scale / --tiny / --remat. `paper` (the default) is
    DSGNConfig.full(): 96 planes, 304x288x10 voxels at 384x1248."""
    p.add_argument("--scale", choices=("paper", "default", "tiny"),
                   default=None,
                   help="DSGN model scale (default: paper; 'default' = the "
                        "mid-size 64-plane config, 'tiny' = test size)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the DSGN hourglass in the backward pass "
                        "(less device memory, slower)")
    p.add_argument("--stem", choices=("s2d", "conv7"), default=None,
                   help="Stereo R-CNN stem (that detector is not ported yet)")
    p.add_argument("--tiny", action="store_true",
                   help="alias for --scale tiny")


def add_device_args(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions")


def make_dsgn_cfg(args):
    """DSGNConfig from the scale flags."""
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    scale = "tiny" if args.tiny else (args.scale or "paper")
    if scale == "tiny":
        return DSGNConfig.tiny()
    if scale == "default":
        return DSGNConfig()
    return DSGNConfig.full(remat=args.remat)


def make_dsgn_model(args, cfg, device):
    """The port's DSGN, frozen for the attack: weights from `--ckpt` (a
    `torch.save`d state dict of this model, e.g. made by
    utils.from_flax) or a fresh seeded init."""
    import torch

    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    model = DSGN(cfg)
    if args.ckpt:
        sd = None if os.path.isdir(args.ckpt) else torch.load(
            args.ckpt, map_location="cpu", weights_only=True)
        if not isinstance(sd, dict) or set(sd) != set(model.state_dict()):
            raise SystemExit(
                f"{args.ckpt} is not a state dict of this package's DSGN at "
                "this scale; the published DSGN checkpoint and orbax "
                "checkpoints are not ported yet (ROADMAP items 8 and 13)")
        model.load_state_dict(sd)
        log(f"loaded DSGN state dict {args.ckpt}")
    else:
        model.init_weights(seed=0)
        log("WARNING: no --ckpt given; using randomly initialized weights")
    return model.to(device).requires_grad_(False).eval()


def log(msg: str):
    print(msg, flush=True)

