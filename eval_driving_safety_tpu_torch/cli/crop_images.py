"""Vehicle crops and their CSV for the dynamic-vehicle classifier.

Counterpart of `eval_driving_safety_tpu.cli.crop_images`, with its flags
and layout: for each Car, Van and Truck of each label file, a square crop
of side max(w, h) + 4 around the box, resized to 224 and written as
`<out_dir>/<frame id>_<line>_<d|s>.png`, `d` where the line's annotation
code is `1` or `-1` (moving) and `s` otherwise; lines coded `n` are
skipped, and lines without an annotation count as `0`. `--csv` also
writes the rows `filename,label` (1 for `d`, 0 for `s`). The resize runs
on `--device`.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.crop_images \\
      --image_dir KITTI/object/training/image_2 \\
      --label_dir KITTI/object/training/label_2 \\
      --annotation_dir kitti_labeled/dynamic_annotation \\
      --out_dir crops --csv crops.csv
"""
from __future__ import annotations

import argparse
import os

import torch

from eval_driving_safety_tpu_torch.cli.common import add_device_args, log


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--annotation_dir", default=None,
                   help="per-line motion codes (n/0/1/-1); names crops "
                        "with the d/s suffix")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--csv", default=None, help="also write filename,label csv")
    add_device_args(p)
    return p.parse_args(argv)


def main(argv=None):
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.data.kitti import (load_image_u8,
                                                          read_label,
                                                          save_image)
    from eval_driving_safety_tpu_torch.models.classifiers import (
        crop_vehicle, label_from_filename)
    args = parse_args(argv)
    device = torch.device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    for name in sorted(os.listdir(args.label_dir)):
        if not name.endswith(".txt"):
            continue
        fid = name.rsplit(".", 1)[0]
        img_path = os.path.join(args.image_dir, fid + ".png")
        if not os.path.exists(img_path):
            continue
        img = u8_to_01(torch.from_numpy(load_image_u8(img_path)).to(device))
        objs = read_label(os.path.join(args.label_dir, name))
        annos = None
        if args.annotation_dir:
            ap = os.path.join(args.annotation_dir, name)
            if os.path.exists(ap):
                with open(ap) as f:
                    annos = f.read().splitlines()
        for i, o in enumerate(objs):
            if o.type not in ("Car", "Van", "Truck"):
                continue
            code = annos[i].strip() if annos and i < len(annos) else "0"
            if code == "n":
                continue
            suffix = "d" if code in ("1", "-1") else "s"
            out_name = f"{fid}_{i}_{suffix}.png"
            save_image(os.path.join(args.out_dir, out_name),
                       crop_vehicle(img, o.bbox).cpu().numpy())
            rows.append((out_name, label_from_filename(out_name)))
    if args.csv:
        with open(args.csv, "w") as f:
            for name, label in rows:
                f.write(f"{name},{label}\n")
    log(f"wrote {len(rows)} crops to {args.out_dir}")


if __name__ == "__main__":
    main()
