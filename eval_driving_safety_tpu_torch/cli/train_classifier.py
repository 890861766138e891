"""Classifier training CLI: road type and dynamic vehicle.

Counterpart of `eval_driving_safety_tpu.cli.train_classifier`, with its
flags, log lines and batch order: CSV-listed images (`filename,label`)
resized to 224 and normalized on `--device`, the backbone frozen at its
seeded init and the head trained with BCE and Adam under the task's LR
ladder, batches in `np.random.RandomState(seed + epoch).permutation`
order with the last partial batch dropped, validation accuracy every 2
epochs, and `{ckpt_dir}/epoch{N}/` (utils.checkpoint: `params`,
`opt_state`, `epoch`) every `ckpt_every` epochs of the task's config (5
where it has none). Dropout draws from a generator seeded `--seed`.
Everything runs in float32 with TF32 off.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.train_classifier \\
      --task dynamic_vehicle --image_dir crops --train_csv train.csv \\
      --val_csv val.csv --ckpt_dir ckpts/dyn
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from eval_driving_safety_tpu_torch.cli.common import (add_device_args, log,
                                                      use_fp32_precision)
from eval_driving_safety_tpu_torch.config import (DynamicVehicleConfig,
                                                   RoadTypeConfig)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--task", choices=("road_type", "dynamic_vehicle"),
                   required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--train_csv", required=True,
                   help="rows `filename,label`")
    p.add_argument("--val_csv", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--ckpt_dir", default="classifier_ckpts")
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p)
    return p.parse_args(argv)


def task_config(task: str):
    return RoadTypeConfig() if task == "road_type" else DynamicVehicleConfig()


def load_batch(image_dir: str, rows, cfg, device):
    """The listed images resized and normalized on `device`: (B, S, S, 3)
    float32 and the (B,) float32 labels."""
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    from eval_driving_safety_tpu_torch.data.kitti import load_image_u8
    from eval_driving_safety_tpu_torch.models.classifiers import \
        resize_normalize
    imgs = [resize_normalize(u8_to_01(torch.from_numpy(load_image_u8(
        os.path.join(image_dir, name))).to(device)), cfg)
        for name, _ in rows]
    labels = torch.tensor([label for _, label in rows], dtype=torch.float32,
                          device=device)
    return torch.stack(imgs), labels


def main(argv=None):
    from eval_driving_safety_tpu_torch.models.classifiers import (
        accuracy, make_classifier, make_dynamic_vehicle_schedule,
        make_road_type_schedule, make_train_state, make_train_step,
        read_csv_dataset)
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        save_checkpoint
    args = parse_args(argv)
    device = torch.device(args.device)
    use_fp32_precision()
    cfg = task_config(args.task)
    epochs = args.epochs or cfg.epochs
    batch = args.batch or cfg.batch_size
    rows = read_csv_dataset(args.train_csv)
    steps_per_epoch = max(len(rows) // batch, 1)
    sched = (make_road_type_schedule(cfg, steps_per_epoch)
             if args.task == "road_type"
             else make_dynamic_vehicle_schedule(cfg, steps_per_epoch))
    model = make_classifier(args.task, cfg).init_weights(args.seed).to(device)
    opt = make_train_state(model, sched)
    step = make_train_step(model, opt)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    val_rows = read_csv_dataset(args.val_csv) if args.val_csv else None
    ckpt_every = getattr(cfg, "ckpt_every", 5)
    for epoch in range(epochs):
        perm = np.random.RandomState(args.seed + epoch).permutation(len(rows))
        losses = []
        for s in range(0, len(rows) - batch + 1, batch):
            chunk = [rows[i] for i in perm[s: s + batch]]
            images, labels = load_batch(args.image_dir, chunk, cfg, device)
            losses.append(step(images, labels, generator=gen))
        mean_loss = float(torch.stack(losses).mean()) if losses else \
            float("nan")
        log(f"epoch {epoch + 1}/{epochs}: loss {mean_loss:.4f}")
        if val_rows and (epoch + 1) % 2 == 0:
            acc = accuracy(model, (
                load_batch(args.image_dir, val_rows[v: v + batch], cfg,
                           device)
                for v in range(0, len(val_rows), batch)))
            log(f"  val accuracy: {acc:.4f}")
        if (epoch + 1) % ckpt_every == 0:
            path = os.path.join(args.ckpt_dir, f"epoch{epoch + 1}")
            save_checkpoint(path, {"params": model.state_dict(),
                                   "opt_state": opt.state_dict(),
                                   "epoch": epoch + 1})
            log(f"  checkpoint -> {path}")


if __name__ == "__main__":
    main()
