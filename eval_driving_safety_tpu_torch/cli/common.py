"""Shared CLI plumbing: dataset and IO flags, DSGN config and weights."""
from __future__ import annotations

import argparse
import json
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
    """The DSGN the attack or predict CLIs run, frozen: weights from
    `--ckpt`, or a fresh seeded init of the port's DSGN. A `--ckpt` ending
    in `.tar` or `.pth` is a published DSGN checkpoint, read into the
    upstream-topology compat model (models.dsgn_compat) with its
    architecture taken from the state dict; any other `--ckpt` is a
    `torch.save`d state dict of the port's DSGN (e.g. made by
    utils.from_flax) or an epoch directory of its trainer
    (cli.train_detector), whose `params` it takes."""
    import torch

    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.utils.checkpoint import (
        is_checkpoint, restore_checkpoint)
    if args.ckpt and args.ckpt.endswith((".tar", ".pth")):
        from eval_driving_safety_tpu_torch.utils.torch_import import \
            load_dsgn_checkpoint
        model, imported = load_dsgn_checkpoint(args.ckpt, cfg)
        log(f"imported published DSGN checkpoint {args.ckpt} into the "
            f"upstream-compat model: arch {imported['arch']}, "
            f"unmapped {len(imported['unmapped'])}"
            + (f" {imported['unmapped'][:8]}" if imported["unmapped"]
               else ""))
        return model.to(device).requires_grad_(False).eval()
    model = DSGN(cfg)
    if args.ckpt:
        if os.path.isdir(args.ckpt):
            sd = restore_checkpoint(args.ckpt)["params"] \
                if is_checkpoint(args.ckpt) else None
        else:
            sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        want = model.state_dict()
        if not isinstance(sd, dict) or set(sd) != set(want) or any(
                sd[k].shape != v.shape for k, v in want.items()):
            raise SystemExit(
                f"{args.ckpt} is neither a state dict of this package's "
                "DSGN at this scale nor a checkpoint of its trainer at this "
                "scale; the JAX trainer's orbax checkpoints (ROADMAP item "
                "13) are not read")
        model.load_state_dict(sd)
        log(f"loaded DSGN weights from {args.ckpt}")
    else:
        model.init_weights(seed=0)
        log("WARNING: no --ckpt given; using randomly initialized weights")
    return model.to(device).requires_grad_(False).eval()


def use_deterministic_kernels(device) -> None:
    """Make runs repeat bit for bit on a CUDA device as far as library
    kernels go (algorithms without a fixed summation order raise instead
    of running), so an attack rerun, or a `--transfer full` run, writes
    the same PNGs. The port's bf16 weight gradient sums in a fixed order;
    its fp32 one sums with f32 atomics, which this setting does not
    reach. Leaves freshly allocated memory
    unfilled: every output the port allocates is written in full."""
    import torch
    if device.type != "cuda":
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def log(msg: str):
    print(msg, flush=True)


def metrics_path(out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, "metrics.jsonl")


def append_metrics(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")

