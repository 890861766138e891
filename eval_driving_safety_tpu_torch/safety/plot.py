"""Scenario and solution plots, drawn in numpy.

Counterpart of eval_driving_safety_tpu/safety/plot.py, which draws with
matplotlib: the same elements within the same limits, rasterized here
at `SCALE` pixels a metre (1000 x 600 for the default limits) and
written as a PNG by `data.kitti.write_png`, so no plotting library is
needed. The rectangles' corners (`_rect_corners`) are the JAX package's;
the pixels are not matplotlib's.

Drawn as matplotlib stacks them: the filled rectangles first (static
obstacles opaque-ish with a black edge, each dynamic obstacle state
faint, the goal region, every max(n // 8, 1)-th ego box outlined), then
the lines (lanelet bounds, the ego trajectory, the initial-state marker).
"""
from __future__ import annotations

import math

import numpy as np

from eval_driving_safety_tpu_torch.data.kitti import write_png

SCALE = 20.0                           # pixels a metre
MARKER = 0.3                           # the start marker's half size (m)

STATIC = (np.array([0x44, 0x77, 0xaa]) / 255.0, 0.8)
DYNAMIC = (np.array([0xee, 0x88, 0x66]) / 255.0, 0.25)
GOAL = (np.array([0x66, 0xbb, 0x66]) / 255.0, 0.4)
BLACK = np.zeros(3)
GREEN = np.array([0.0, 0x80 / 255.0, 0.0])
LANE = np.full(3, 0xcc / 255.0)


def _rect_corners(cx, cy, length, width, orient):
    c, s = math.cos(orient), math.sin(orient)
    pts = np.array([[length / 2, width / 2], [length / 2, -width / 2],
                    [-length / 2, -width / 2], [-length / 2, width / 2]])
    rot = pts @ np.array([[c, s], [-s, c]])
    return rot + np.array([cx, cy])


def to_pixels(points, xlim, ylim) -> np.ndarray:
    """World (x, y) -> continuous pixel (column, row): pixel (i, j) covers
    columns [j, j + 1) and rows [i, i + 1); y points up."""
    p = np.asarray(points, np.float64).reshape(-1, 2)
    return np.stack([(p[:, 0] - xlim[0]) * SCALE,
                     (ylim[1] - p[:, 1]) * SCALE], axis=1)


class _Canvas:
    def __init__(self, xlim, ylim):
        self.xlim, self.ylim = xlim, ylim
        self.w = int(round((xlim[1] - xlim[0]) * SCALE))
        self.h = int(round((ylim[1] - ylim[0]) * SCALE))
        self.img = np.ones((self.h, self.w, 3))

    def fill(self, corners, color, alpha):
        """Blend the convex polygon `corners` (world) over the canvas at
        every pixel whose center lies inside it."""
        q = to_pixels(corners, self.xlim, self.ylim)
        j0 = max(int(math.floor(q[:, 0].min())), 0)
        j1 = min(int(math.ceil(q[:, 0].max())), self.w)
        i0 = max(int(math.floor(q[:, 1].min())), 0)
        i1 = min(int(math.ceil(q[:, 1].max())), self.h)
        if j0 >= j1 or i0 >= i1:
            return
        u, v = np.meshgrid(np.arange(j0, j1) + 0.5, np.arange(i0, i1) + 0.5)
        a, b = q, np.roll(q, -1, axis=0)
        cross = ((b[:, 0] - a[:, 0])[:, None, None] * (v - a[:, 1, None, None])
                 - (b[:, 1] - a[:, 1])[:, None, None]
                 * (u - a[:, 0, None, None]))
        inside = (cross >= 0).all(0) | (cross <= 0).all(0)
        patch = self.img[i0:i1, j0:j1]
        patch[inside] = alpha * color + (1.0 - alpha) * patch[inside]

    def line(self, points, color, width_px=1):
        """A polyline through `points` (world), `width_px` wide."""
        q = to_pixels(points, self.xlim, self.ylim)
        if len(q) == 1:
            q = np.concatenate([q, q])
        seg = q[1:] - q[:-1]
        n = np.maximum(np.ceil(np.hypot(seg[:, 0], seg[:, 1]) * 2), 1)
        n = n.astype(int)
        first = np.repeat(np.cumsum(n) - n, n)
        t = (np.arange(n.sum()) - first) / np.repeat(n, n)
        starts = np.repeat(q[:-1], n, axis=0)
        pts = np.concatenate([starts + np.repeat(seg, n, axis=0) * t[:, None],
                              q[-1:]])
        cols = np.floor(pts[:, 0]).astype(int)
        rows = np.floor(pts[:, 1]).astype(int)
        r = np.arange(width_px) - (width_px - 1) // 2
        dc, dr = np.meshgrid(r, r)
        cols = (cols[:, None] + dc.ravel()).ravel()
        rows = (rows[:, None] + dr.ravel()).ravel()
        ok = (cols >= 0) & (cols < self.w) & (rows >= 0) & (rows < self.h)
        self.img[rows[ok], cols[ok]] = color

    def polygon(self, corners, color, width_px=1):
        self.line(np.concatenate([corners, corners[:1]]), color, width_px)


def render_scenario(scenario, trajectory=None, xlim=(-10, 40),
                    ylim=(-15, 15)) -> np.ndarray:
    """The plot as an (H, W, 3) uint8 RGB image."""
    cv = _Canvas(xlim, ylim)
    for ob in scenario.static_obstacles:
        st = ob.initial_state
        corners = _rect_corners(st.position[0], st.position[1],
                                ob.shape.length, ob.shape.width,
                                st.orientation)
        cv.fill(corners, *STATIC)
        cv.polygon(corners, BLACK)
    for ob in scenario.dynamic_obstacles:
        for st in [ob.initial_state] + list(ob.trajectory.states):
            cv.fill(_rect_corners(st.position[0], st.position[1],
                                  ob.shape.length, ob.shape.width,
                                  st.orientation), *DYNAMIC)
    for pp in scenario.planning_problems:
        gp = pp.goal.position
        corners = _rect_corners(gp.center[0], gp.center[1], gp.length,
                                gp.width, gp.orientation)
        cv.fill(corners, *GOAL)
        cv.polygon(corners, GREEN)
    if trajectory is not None:
        for s in trajectory.states[:: max(len(trajectory.states) // 8, 1)]:
            cv.polygon(_rect_corners(s.position[0], s.position[1], 4.508,
                                     1.610, s.orientation), GREEN)
    for ll in scenario.lanelets:
        cv.line(ll.left_bound, LANE)
        cv.line(ll.right_bound, LANE)
    if trajectory is not None:
        cv.line([s.position for s in trajectory.states], GREEN, 3)
    for pp in scenario.planning_problems:
        x, y = pp.initial_state.position[:2]
        r = MARKER
        cv.fill(np.array([[x, y + r], [x - r, y - r], [x + r, y - r]]),
                BLACK, 1.0)
    return np.round(cv.img * 255.0).astype(np.uint8)


def plot_scenario(scenario, out_path: str, trajectory=None,
                  xlim=(-10, 40), ylim=(-15, 15)):
    write_png(out_path, render_scenario(scenario, trajectory, xlim, ylim),
              compress_level=6)


def plot_solution(scenario, trajectory, out_path: str, **kw):
    plot_scenario(scenario, out_path, trajectory=trajectory, **kw)
