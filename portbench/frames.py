"""The traffic's frames: seeded KITTI-layout stereo pairs, their calib and
label files, and a split file of unique frame ids hard-linked onto them.
The frames are deflated PNGs at the level the traffic names (KITTI's are
deflated: the loader pays inflate and unfilter, as on the real set).

The scenes are those of the port's chip check (smooth random colour
blocks with noise, the right view shifted by a disparity that falls
with the row), with 2-4 Cars a pair drawn from the seed. Every seed makes
the same sizes and the same number of Cars over the pairs, in another
order, so the seed changes the values and not the amount of work."""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from portbench import png

# KITTI's object-devkit calibration of a training frame (000000)
CALIB = ("P2: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 "
         "0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 "
         "0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03\n"
         "P3: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 "
         "0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 "
         "0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03\n"
         "R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 "
         "9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 "
         "9.999631e-01\n"
         "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 "
         "-4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 "
         "-7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 "
         "-2.717806e-01\n")
P2 = np.array([[7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01],
               [0.0, 7.215377e+02, 1.728540e+02, 2.163791e-01],
               [0.0, 0.0, 1.0, 2.745884e-03]])
P3 = np.array([[7.215377e+02, 0.0, 6.095593e+02, -3.395242e+02],
               [0.0, 7.215377e+02, 1.728540e+02, 2.199936e+00],
               [0.0, 0.0, 1.0, 2.729905e-03]])


@dataclass
class Car:
    dims: tuple            # h, w, l (m)
    loc: tuple             # x, y (bottom), z in the rectified camera frame
    ry: float
    bbox: tuple            # x1, y1, x2, y2 in the left image

    @property
    def alpha(self) -> float:
        """The observation angle, as the label file holds it."""
        a = self.ry - math.atan2(self.loc[0], self.loc[2])
        return round(math.atan2(math.sin(a), math.cos(a)), 2)

    def line(self) -> str:
        return ("Car 0.00 0 " + f"{self.alpha:.2f} "
                + " ".join(f"{v:.2f}" for v in (*self.bbox, *self.dims,
                                                *self.loc, self.ry)))


@dataclass
class Traffic:
    root: str                       # KITTI object dir the CLI reads
    split: str                      # split file of unique frame ids
    ids: List[str]
    pair_of: Dict[str, int]         # frame id -> index of its pair
    left: List[np.ndarray]          # (H, W, 3) uint8 RGB per pair
    right: List[np.ndarray]
    cars: List[List[Car]]


def box_corners(dims, loc, ry) -> np.ndarray:
    """(8, 3) corners of a KITTI box (location = bottom centre)."""
    h, w, l = dims
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    z = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    y = np.array([0, 0, 0, 0, -1, -1, -1, -1]) * h
    c, s = math.cos(ry), math.sin(ry)
    return np.stack([c * x + s * z + loc[0], y + loc[1],
                     -s * x + c * z + loc[2]], axis=1)


def project_box(dims, loc, ry, p, height, width) -> tuple:
    pts = box_corners(dims, loc, ry)
    uvw = np.concatenate([pts, np.ones((8, 1))], axis=1) @ p.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    return (float(np.clip(uv[:, 0].min(), 0, width - 1)),
            float(np.clip(uv[:, 1].min(), 0, height - 1)),
            float(np.clip(uv[:, 0].max(), 0, width - 1)),
            float(np.clip(uv[:, 1].max(), 0, height - 1)))


def draw_cars(rng, n, height, width) -> List[Car]:
    cars = []
    for _ in range(n):
        dims = (rng.uniform(1.40, 1.70), rng.uniform(1.55, 1.80),
                rng.uniform(3.50, 4.50))
        z = rng.uniform(10.0, 45.0)
        loc = (rng.uniform(-0.25, 0.25) * z, rng.uniform(1.55, 1.75), z)
        ry = rng.uniform(-math.pi, math.pi)
        cars.append(Car(tuple(round(v, 2) for v in dims),
                        tuple(round(v, 2) for v in loc), round(ry, 2),
                        tuple(round(v, 2) for v in project_box(
                            dims, loc, ry, P2, height, width))))
    return cars


def draw_scene(rng, height, width):
    """Smooth random colour blocks with noise; the right view is the left
    shifted left by 8 + 40 * row / height pixels."""
    coarse = rng.integers(0, 256, (height // 15 + 2, width // 18 + 2, 3))
    left = np.repeat(np.repeat(coarse, 15, 0), 18, 1)[:height, :width]
    left = np.clip(left + rng.integers(-12, 13, left.shape), 0, 255)
    left = left.astype(np.uint8)
    right = np.empty_like(left)
    for y in range(height):
        right[y] = np.roll(left[y], -int(8 + 40 * y / height), axis=0)
    return left, right


def make_traffic(root: str, seed: int, spec: dict) -> Traffic:
    """Write `spec["pairs"]` seeded pairs under root/pool and a KITTI
    object dir root/kitti whose `spec["split_ids"]` frame ids are hard
    links onto them, id j on pair j mod pairs."""
    rng = np.random.default_rng(seed)
    n, h, w = spec["pairs"], spec["height"], spec["width"]
    lo, hi = spec["cars"]
    counts = [lo + i % (hi - lo + 1) for i in range(n)]
    counts = [counts[i] for i in rng.permutation(n)]
    pool, kitti = os.path.join(root, "pool"), os.path.join(root, "kitti")
    subs = ("image_2", "image_3", "calib", "label_2")
    for d in (pool, kitti):
        for sub in subs:
            os.makedirs(os.path.join(d, sub), exist_ok=True)
    lefts, rights, cars, images = [], [], [], []
    for k in range(n):
        left, right = draw_scene(rng, h, w)
        cs = draw_cars(rng, counts[k], h, w)
        lefts.append(left)
        rights.append(right)
        cars.append(cs)
        name = f"{k:06d}"
        images += [(os.path.join(pool, "image_2", name + ".png"), left),
                   (os.path.join(pool, "image_3", name + ".png"), right)]
        with open(os.path.join(pool, "calib", name + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(pool, "label_2", name + ".txt"), "w") as f:
            f.write("".join(c.line() + "\n" for c in cs))
    with ThreadPoolExecutor(4) as ex:            # zlib drops the GIL
        list(ex.map(lambda pi: png.write(*pi, spec["png_level"]), images))
    ids, pair_of = [], {}
    for j in range(spec["split_ids"]):
        fid, k = f"{j:06d}", j % n
        for sub, ext in zip(subs, (".png", ".png", ".txt", ".txt")):
            os.link(os.path.join(pool, sub, f"{k:06d}{ext}"),
                    os.path.join(kitti, sub, fid + ext))
        ids.append(fid)
        pair_of[fid] = k
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write("".join(i + "\n" for i in ids))
    return Traffic(kitti, split, ids, pair_of, lefts, rights, cars)
