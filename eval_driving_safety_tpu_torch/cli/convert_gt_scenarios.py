"""Ground-truth labels -> CommonRoad scenarios.

Counterpart of `eval_driving_safety_tpu.cli.convert_gt_scenarios`, with
its flags and layout: the static_label, dynamic_label (+ annotation) and
road_dynamic_label (+ annotation) frames of a `kitti_labeled/` tree,
with the n/0/1/-1 codes and the seeded constant-velocity rollouts, to
`<output_folder>/<id>.xml`. Runs on the host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.convert_gt_scenarios \\
      --input_folder kitti_labeled/ --output_folder scenarios/gt
"""
from __future__ import annotations

import argparse

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.safety.convert import convert_gt_folder


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input_folder", required=True,
                   help="kitti_labeled/ tree (static_label, dynamic_label, "
                        "dynamic_annotation, road_dynamic_label, "
                        "road_dynamic_annotation)")
    p.add_argument("--output_folder", required=True)
    p.add_argument("--direction", choices=("straight", "left", "right"),
                   default="straight")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    written = convert_gt_folder(args.input_folder, args.output_folder,
                                direction=args.direction, seed=args.seed)
    log(f"wrote {len(written)} GT scenarios to {args.output_folder}")


if __name__ == "__main__":
    main()
