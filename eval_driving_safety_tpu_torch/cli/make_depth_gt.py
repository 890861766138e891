"""Per-frame depth ground truth from KITTI velodyne scans.

Counterpart of `eval_driving_safety_tpu.cli.make_depth_gt`, with the same
flags and output: each `velodyne/<id>.bin` scan is projected through
`calib/<id>.txt` into a sparse (H, W) float32 depth map (0 = no return)
saved as `<out_dir>/<id>.npy`, the format `--depth_dir` reads in the
training and attack CLIs. Host-only (numpy).

Usage:
  python -m eval_driving_safety_tpu_torch.cli.make_depth_gt \\
      --data_path KITTI/object/training --out_dir depth_gt
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from eval_driving_safety_tpu_torch.cli.common import log
from eval_driving_safety_tpu_torch.data.kitti import read_calib
from eval_driving_safety_tpu_torch.inference.depth_export import \
    load_velodyne


def velodyne_to_depth_map(points: np.ndarray, calib, height: int,
                          width: int) -> np.ndarray:
    """(N, 4) velodyne points -> sparse (H, W) depth map (0 = no return).

    Points go velo -> rectified camera through Tr_velo_to_cam and R0,
    then through P2 to pixels; the nearest return wins per pixel."""
    xyz = points[:, :3]
    if calib.Tr_velo_to_cam is not None:
        xyz = xyz @ calib.Tr_velo_to_cam[:, :3].T + calib.Tr_velo_to_cam[:, 3]
    xyz = xyz @ calib.R0.T
    xyz = xyz[xyz[:, 2] > 0.5]
    uv = calib.project_rect_to_image(xyz)
    u = np.round(uv[:, 0]).astype(int)
    v = np.round(uv[:, 1]).astype(int)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z = u[ok], v[ok], xyz[ok, 2]
    depth = np.zeros((height, width), np.float32)
    # written in decreasing depth, so a closer return overwrites
    order = np.argsort(-z)
    depth[v[order], u[order]] = z[order]
    return depth


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_path", required=True,
                   help="KITTI object dir with velodyne/ calib/ image_2/")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    args = p.parse_args(argv)
    velo_dir = os.path.join(args.data_path, "velodyne")
    calib_dir = os.path.join(args.data_path, "calib")
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(velo_dir)):
        if not name.endswith(".bin"):
            continue
        fid = name.rsplit(".", 1)[0]
        calib = read_calib(os.path.join(calib_dir, fid + ".txt"))
        pts = load_velodyne(os.path.join(velo_dir, name))
        depth = velodyne_to_depth_map(pts, calib, args.height, args.width)
        np.save(os.path.join(args.out_dir, fid + ".npy"), depth)
        n += 1
    log(f"wrote {n} depth maps to {args.out_dir}")


if __name__ == "__main__":
    main()
