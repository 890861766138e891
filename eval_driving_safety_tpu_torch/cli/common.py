"""Shared CLI plumbing: dataset and IO flags, DSGN and Stereo R-CNN
configs and weights."""
from __future__ import annotations

import argparse
import contextlib
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
                   help="Stereo R-CNN stem formulation (attack default "
                        "s2d); both are the same 7x7/2 conv, which the "
                        "port computes as one conv")
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


def read_epoch_dir(ckpt: str, takes: str):
    """(tree, from_orbax) of the epoch directory `ckpt`: a checkpoint of
    the port's trainer, or the JAX trainer's orbax checkpoint (Flax
    layout). Where it is neither, exits with the reader's reason and what
    `--ckpt` takes."""
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        read_trainer_checkpoint
    try:
        return read_trainer_checkpoint(ckpt)
    except ValueError as e:
        raise SystemExit(f"{e}; --ckpt takes {takes}") from None


def bridged(bridge, params, *args):
    """`params` of an orbax tree through a utils.from_flax bridge, or None
    where the tree has none or the bridge cannot map it (a tree of
    another model: the caller's shape check refuses it)."""
    if not isinstance(params, dict):
        return None
    try:
        return bridge(params, *args)
    except (ValueError, AttributeError):
        return None


def load_checked(model, sd, refusal: str) -> None:
    """Load the state dict `sd` into `model` if it has the model's keys at
    the model's shapes; else exit with `refusal`."""
    want = model.state_dict()
    if not isinstance(sd, dict) or set(sd) != set(want) or any(
            sd[k].shape != v.shape for k, v in want.items()):
        raise SystemExit(refusal)
    model.load_state_dict(sd)


def make_dsgn_model(args, cfg, device):
    """The DSGN the attack or predict CLIs run, frozen: weights from
    `--ckpt`, or a fresh seeded init of the port's DSGN. A `--ckpt` ending
    in `.tar` or `.pth` is a published DSGN checkpoint, read into the
    upstream-topology compat model (models.dsgn_compat) with its
    architecture taken from the state dict; any other `--ckpt` is a
    `torch.save`d state dict of the port's DSGN (e.g. made by
    utils.from_flax) or an epoch directory of its trainer
    (cli.train_detector) or of the JAX package's trainer (orbax, read by
    utils.orbax_read and bridged by utils.from_flax), whose `params` it
    takes."""
    import torch

    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        dsgn_state_dict_from_flax
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
        takes = ("a published DSGN .tar or .pth, a torch.save'd state dict "
                 "of this package's DSGN, or an epoch directory of this "
                 "package's trainer (checkpoint.pt) or of the JAX "
                 "package's trainer (orbax)")
        from_orbax = False
        if os.path.isdir(args.ckpt):
            tree, from_orbax = read_epoch_dir(args.ckpt, takes)
            sd = tree.get("params") if isinstance(tree, dict) else None
            if from_orbax:
                sd = bridged(dsgn_state_dict_from_flax, sd)
        else:
            sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        load_checked(model, sd, f"{args.ckpt} holds no DSGN weights at "
                     f"this scale; --ckpt takes {takes}")
        log(f"loaded DSGN weights from {args.ckpt}"
            + (" (the JAX trainer's orbax checkpoint)" if from_orbax
               else ""))
    else:
        model.init_weights(seed=0)
        log("WARNING: no --ckpt given; using randomly initialized weights")
    return model.to(device).requires_grad_(False).eval()


def make_srcnn_cfg(args, default_bf16: bool = False,
                   default_s2d: bool = False):
    """StereoRCNNConfig from the flags: `--tiny` gives the tiny config;
    the trunk is bf16 where `default_bf16` or `--bf16` asks, and `--fp32`
    wins over both; `--stem` overrides the stem (s2d where `default_s2d`,
    else the config's). `--scale` is a DSGN flag and is not read."""
    import dataclasses

    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    cfg = StereoRCNNConfig.tiny() if getattr(args, "tiny", False) \
        else StereoRCNNConfig()
    bf16 = not getattr(args, "fp32", False) and (
        default_bf16 or getattr(args, "bf16", False))
    stem = getattr(args, "stem", None) or \
        ("s2d" if default_s2d else cfg.stem_method)
    return dataclasses.replace(cfg, dtype="bfloat16" if bf16 else cfg.dtype,
                               stem_method=stem)


def make_srcnn_model(args, cfg, device):
    """The Stereo R-CNN the attack runs, frozen, and its loss weights
    `uncert` (6,): `--ckpt` is the published checkpoint (`.pth` or
    `.tar`, upstream layout: its weights, its keypoint conv count and its
    `uncert`), an epoch directory of the port's trainer or of the JAX
    package's (orbax; `params`, and `uncert` where it has one) or a
    `torch.save`d state dict of the port's StereoRCNN (utils.from_flax
    makes one from Flax weights); without it a seeded fresh init, and
    `uncert` is 0. In bf16 the kernels are cast once
    (`cast_matmul_params`)."""
    import torch

    from eval_driving_safety_tpu_torch.models.common import \
        cast_matmul_params
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        stereo_rcnn_state_dict_from_flax
    uncert = torch.zeros(6)
    ckpt = args.ckpt
    if ckpt and ckpt.endswith((".tar", ".pth")):
        from eval_driving_safety_tpu_torch.utils.torch_import import \
            load_stereo_rcnn_checkpoint
        model, imported, file_uncert = load_stereo_rcnn_checkpoint(ckpt, cfg)
        if imported["unmapped"]:
            log(f"WARNING: {len(imported['unmapped'])} torch keys "
                f"unmapped: {imported['unmapped'][:8]}...")
        if file_uncert is not None:
            uncert = file_uncert
        log(f"imported torch checkpoint {ckpt} "
            f"(kpts convs={imported['num_kpts_convs']}, "
            f"unmapped={len(imported['unmapped'])})")
    elif ckpt:
        takes = ("a published Stereo R-CNN .pth or .tar, a torch.save'd "
                 "state dict of this package's StereoRCNN, or an epoch "
                 "directory of this package's trainer (checkpoint.pt) or "
                 "of the JAX package's trainer (orbax)")
        model = StereoRCNN(cfg)
        from_orbax = False
        if os.path.isdir(ckpt):
            tree, from_orbax = read_epoch_dir(ckpt, takes)
            tree = tree if isinstance(tree, dict) else {}
            sd = tree.get("params")
            if from_orbax:
                sd = bridged(stereo_rcnn_state_dict_from_flax, sd, model)
            if tree.get("uncert") is not None:
                uncert = torch.as_tensor(tree["uncert"], dtype=torch.float32)
        else:
            sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        load_checked(model, sd, f"{ckpt} holds no Stereo R-CNN weights at "
                     f"this config; --ckpt takes {takes}")
        log(f"loaded Stereo R-CNN weights from {ckpt}"
            + (" (the JAX trainer's orbax checkpoint)" if from_orbax else "")
            + (f", uncert {uncert.tolist()}" if uncert.any() else ""))
    else:
        model = StereoRCNN(cfg).init_weights(seed=0)
        log("WARNING: no --ckpt given; using randomly initialized weights")
    model = model.to(device).requires_grad_(False).eval()
    if cfg.dtype == "bfloat16":
        cast_matmul_params(model)
    return model, uncert.to(device)


def load_classifier(task: str, cfg, ckpt: str, device):
    """The scene classifier of `task` at `cfg`, frozen and in eval mode,
    with the `params` of `ckpt`, an epoch directory of cli.train_classifier
    or of the JAX package's train_classifier (orbax)."""
    from eval_driving_safety_tpu_torch.models.classifiers import \
        make_classifier
    from eval_driving_safety_tpu_torch.utils.from_flax import (
        dynamic_vehicle_state_dict_from_flax, road_type_state_dict_from_flax)
    takes = ("an epoch directory of this package's train_classifier "
             "(checkpoint.pt) or of the JAX package's (orbax)")
    model = make_classifier(task, cfg)
    tree, from_orbax = read_epoch_dir(ckpt, takes)
    sd = tree.get("params") if isinstance(tree, dict) else None
    if from_orbax:
        sd = bridged(road_type_state_dict_from_flax if task == "road_type"
                     else dynamic_vehicle_state_dict_from_flax, sd)
    load_checked(model, sd, f"{ckpt} holds no {task} classifier at image "
                 f"size {cfg.image_size}; --ckpt takes {takes}")
    return model.to(device).requires_grad_(False).eval()


def use_fp32_precision() -> None:
    """Compute float32 in float32: TF32 off in cuDNN's convs and cuBLAS's
    products."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def use_srcnn_precision(cfg) -> None:
    """A float32 Stereo R-CNN computes in float32 (bf16 configs leave the
    TF32 flags alone)."""
    if cfg.dtype == "float32":
        use_fp32_precision()


def use_deterministic_kernels(device) -> None:
    """Make runs repeat bit for bit on a CUDA device as far as library
    kernels go (algorithms without a fixed summation order raise instead
    of running), so an attack rerun, or a `--transfer full` run, writes
    the same PNGs. The port's own kernels (the weight gradient's too, in
    either dtype) sum in a fixed order. Leaves freshly allocated memory
    unfilled: every output the port allocates is written in full."""
    import torch
    if device.type != "cuda":
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def log(msg: str):
    """Print `msg`; in a torchrun launch of several ranks, rank 0 alone
    prints."""
    if os.environ.get("RANK", "0") == "0":
        print(msg, flush=True)


@contextlib.contextmanager
def process_group(args):
    """Around a CLI's run: join the torchrun launch this process belongs
    to (`parallel.sharding.init_process_group`; without torchrun a world
    of one), point `args.device` at the rank's device (`cuda` becomes
    card LOCAL_RANK; `cpu` stays), and leave the group after the run,
    which has finished its writes by then. Yields the rank's Mesh."""
    from eval_driving_safety_tpu_torch.parallel import sharding
    mesh = sharding.init_process_group(args.device)
    args.device = str(mesh.device)
    try:
        yield mesh
    finally:
        sharding.destroy_process_group()


def metrics_path(out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, "metrics.jsonl")


def append_metrics(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")

