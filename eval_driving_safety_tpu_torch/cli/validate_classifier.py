"""Classifier validation CLI.

Counterpart of `eval_driving_safety_tpu.cli.validate_classifier`, with
its flags and print format: restore an epoch directory of
cli.train_classifier, score the validation CSV's images (resized and
normalized on `--device`) and print the accuracy at probability > 0.5,
overall and per class.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.validate_classifier \\
      --task dynamic_vehicle --image_dir crops --val_csv val.csv \\
      --ckpt ckpts/dyn/epoch10
"""
from __future__ import annotations

import argparse

import torch

from eval_driving_safety_tpu_torch.cli.common import (add_device_args,
                                                      load_classifier, log,
                                                      use_fp32_precision)
from eval_driving_safety_tpu_torch.cli.train_classifier import (load_batch,
                                                                task_config)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--task", choices=("road_type", "dynamic_vehicle"),
                   required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--val_csv", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--batch", type=int, default=32)
    add_device_args(p)
    return p.parse_args(argv)


def main(argv=None):
    from eval_driving_safety_tpu_torch.models.classifiers import (
        make_eval_step, read_csv_dataset)
    args = parse_args(argv)
    device = torch.device(args.device)
    use_fp32_precision()
    cfg = task_config(args.task)
    step = make_eval_step(load_classifier(args.task, cfg, args.ckpt, device))
    rows = read_csv_dataset(args.val_csv)
    correct = {0: 0, 1: 0}
    total = {0: 0, 1: 0}
    for s in range(0, len(rows), args.batch):
        chunk = rows[s: s + args.batch]
        images, _ = load_batch(args.image_dir, chunk, cfg, device)
        probs = step(images).cpu().numpy()
        for (_, label), prob in zip(chunk, probs):
            total[label] += 1
            if (prob > 0.5) == bool(label):
                correct[label] += 1
    n_total = total[0] + total[1]
    n_correct = correct[0] + correct[1]
    log(f"accuracy: {n_correct / max(n_total, 1):.4f} "
        f"({n_correct}/{n_total})")
    for c in (0, 1):
        if total[c]:
            log(f"  class {c}: {correct[c] / total[c]:.4f} "
                f"({correct[c]}/{total[c]})")


if __name__ == "__main__":
    main()
