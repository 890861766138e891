"""Run the road-type and dynamic-vehicle classifiers over a split and
write the `kitti_labeled/`-style folders that the scenario converters
read.

Counterpart of `eval_driving_safety_tpu.cli.classify_split`, with its
flags and layout:

  out_dir/
    road_dynamic_label/<id>.txt       (highway frames: copy of label file)
    road_dynamic_annotation/<id>.txt  (one code per label line)
    dynamic_label/<id>.txt            (street frames)
    dynamic_annotation/<id>.txt

A frame is highway where the road-type classifier scores its full left
image >= `--thresh`. Codes: `n` for a line that is not a vehicle (Car,
Van, Truck, Misc), `1` for a vehicle whose square max(w, h) + 4 crop the
dynamic-vehicle classifier scores >= `--thresh` (moving), `0` otherwise.
Without `--road_ckpt` every frame is street; without `--dyn_ckpt` every
vehicle is `0`. Checkpoints are epoch directories of
cli.train_classifier. Frames are resized, cropped and scored on
`--device`, in float32 with TF32 off; a frame's crops go through the
classifier as one batch.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.classify_split \\
      --data_path KITTI/object/training --split_file val.txt \\
      --label_dir results/data \\
      --road_ckpt ckpts/road/epoch20 --dyn_ckpt ckpts/dyn/epoch10 \\
      --out_dir kitti_labeled_pred
"""
from __future__ import annotations

import argparse
import os
import shutil

import torch

from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, load_classifier, log, make_dataset,
    use_fp32_precision)
from eval_driving_safety_tpu_torch.cli.train_classifier import task_config

# the scenario converters' obstacle classes
VEHICLE_CLASSES = ("Car", "Van", "Truck", "Misc")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--label_dir", default=None,
                   help="label txts to bucket (detections or GT); default: "
                        "the dataset's label_2")
    p.add_argument("--road_ckpt", default=None,
                   help="road-type classifier checkpoint directory; without "
                        "it every frame is classed street")
    p.add_argument("--dyn_ckpt", default=None,
                   help="dynamic-vehicle classifier checkpoint directory; "
                        "without it every vehicle is classed static ('0')")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--thresh", type=float, default=0.5)
    add_device_args(p)
    return p.parse_args(argv)


def frame_scores(img01: torch.Tensor, objs, road_step, dyn_step):
    """One frame's scores: the road-type probability of the (H, W, 3)
    [0, 1] frame (None without `road_step`) and, per label line, the
    dynamic-vehicle probability of its crop (None for a line that is not
    a vehicle, and for every line without `dyn_step`). Each step is
    (eval step, its config)."""
    from eval_driving_safety_tpu_torch.models.classifiers import (
        crop_vehicle, resize_normalize)
    road = None
    if road_step is not None:
        step, cfg = road_step
        road = float(step(resize_normalize(img01, cfg)[None])[0])
    scores = [None] * len(objs)
    vehicles = [i for i, o in enumerate(objs) if o.type in VEHICLE_CLASSES]
    if dyn_step is not None and vehicles:
        step, cfg = dyn_step
        crops = torch.stack([resize_normalize(
            crop_vehicle(img01, objs[i].bbox), cfg) for i in vehicles])
        for i, p in zip(vehicles, step(crops).cpu().tolist()):
            scores[i] = p
    return road, scores


def main(argv=None):
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.data.kitti import read_label
    from eval_driving_safety_tpu_torch.models.classifiers import \
        make_eval_step
    args = parse_args(argv)
    device = torch.device(args.device)
    use_fp32_precision()
    ds = make_dataset(args)
    label_dir = args.label_dir or ds.label_dir

    def classifier(task, ckpt):
        if not ckpt:
            return None
        cfg = task_config(task)
        return make_eval_step(load_classifier(task, cfg, ckpt, device)), cfg
    road_step = classifier("road_type", args.road_ckpt)
    dyn_step = classifier("dynamic_vehicle", args.dyn_ckpt)

    for sub in ("road_dynamic_label", "road_dynamic_annotation",
                "dynamic_label", "dynamic_annotation"):
        os.makedirs(os.path.join(args.out_dir, sub), exist_ok=True)

    n_highway = n_frames = 0
    for i in range(len(ds)):
        fid = ds.ids[i]
        label_path = os.path.join(label_dir, fid + ".txt")
        if not os.path.exists(label_path):
            continue
        n_frames += 1
        img01 = u8_to_01(torch.from_numpy(ds.get(i).im_left).to(device))
        objs = read_label(label_path)
        road, scores = frame_scores(img01, objs, road_step, dyn_step)
        is_highway = road is not None and road >= args.thresh
        n_highway += int(is_highway)
        codes = ["n" if o.type not in VEHICLE_CLASSES
                 else "0" if s is None
                 else "1" if s >= args.thresh else "0"
                 for o, s in zip(objs, scores)]
        bucket = "road_dynamic" if is_highway else "dynamic"
        shutil.copy(label_path, os.path.join(
            args.out_dir, f"{bucket}_label", fid + ".txt"))
        with open(os.path.join(args.out_dir, f"{bucket}_annotation",
                               fid + ".txt"), "w") as f:
            f.write("\n".join(codes) + ("\n" if codes else ""))
    log(f"classified {n_frames} frames: {n_highway} highway, "
        f"{n_frames - n_highway} street -> {args.out_dir}")


if __name__ == "__main__":
    main()
