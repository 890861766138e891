"""Detection labels -> CommonRoad scenarios.

Counterpart of `eval_driving_safety_tpu.cli.convert_scenarios`, with its
flags and layout: each detection txt (16-field KITTI lines, every
vehicle kept whatever its score) becomes `<output_folder>/<id>.xml`,
all obstacles static, in the highway band where `<id>.txt` is in
`--dyna_obj_folder`. Runs on the host.

Usage:
  python -m eval_driving_safety_tpu_torch.cli.convert_scenarios \\
      --input_folder results/pgd4/data --output_folder scenarios/pgd4 \\
      --dyna_obj_folder kitti_labeled/road_dynamic_label
"""
from __future__ import annotations

import argparse

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.safety.convert import \
    convert_detection_folder


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input_folder", required=True,
                   help="folder of KITTI detection label txts")
    p.add_argument("--output_folder", required=True)
    p.add_argument("--dyna_obj_folder", default=None,
                   help="road-dynamic label folder (presence of <id>.txt "
                        "=> highway band)")
    p.add_argument("--direction", choices=("straight", "left", "right"),
                   default="straight")
    args = p.parse_args(argv)
    written = convert_detection_folder(
        args.input_folder, args.output_folder,
        road_dynamic_label_dir=args.dyna_obj_folder,
        direction=args.direction)
    log(f"wrote {len(written)} scenarios to {args.output_folder}")


if __name__ == "__main__":
    main()
