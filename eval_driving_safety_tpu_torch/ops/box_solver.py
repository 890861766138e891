"""3D box estimation from stereo 2D boxes and the perspective keypoint.

Counterpart of eval_driving_safety_tpu/ops/box_solver.py, in numpy f64
as the reference is: Gauss-Newton on the sparse reprojection
constraints of the Stereo R-CNN paper. The 3D box (dimensions from the
dimension head, the viewpoint alpha from the orientation head) must
project onto the observed left box edges (ul, vt, ur, vb), the right
box's horizontal edges (ul', ur') and the keypoint's column. Jacobians
are forward differences (step 1e-4), the normal equations are damped by
1e-3, and a solve succeeds where the state is finite, 0.5 < z < 200 and
the final cost is under 1e4. The DSGN export shares the corner
convention (inference.fcos3d_post.box3d_corners).
"""
from __future__ import annotations

import math

import numpy as np


def _box_corners_cam(x, y, z, dims, theta) -> np.ndarray:
    """8 corners in camera frame; y is the bottom face (KITTI)."""
    h, w, l = dims
    lu = np.array([1, 1, -1, -1], np.float64) * (l / 2.0)
    wv = np.array([1, -1, -1, 1], np.float64) * (w / 2.0)
    cx = x + lu * np.cos(theta) + wv * np.sin(theta)
    cz = z - lu * np.sin(theta) + wv * np.cos(theta)
    bottom = np.stack([cx, np.full(4, y), cz], axis=1)
    top = bottom - np.array([0.0, h, 0.0])
    return np.concatenate([bottom, top], axis=0)


def initial_state(calib, alpha, dims, box_left, box_right):
    """Init from center disparity + viewpoint geometry."""
    uc_l = (box_left[0] + box_left[2]) / 2.0
    uc_r = (box_right[0] + box_right[2]) / 2.0
    vc = (box_left[1] + box_left[3]) / 2.0
    disp = max(uc_l - uc_r, 0.5)
    z = calib.f_u * calib.baseline / disp
    x = (uc_l - calib.c_u) * z / calib.f_u
    y = (vc - calib.c_v) * z / calib.f_u + dims[0] / 2.0
    theta = alpha + math.atan2(x, z)
    return np.array([x, y, z, theta])


def _batch_residuals(state, dims, box_left, box_right, kpt_u, kpt_idx,
                     calib, z_fixed=None) -> np.ndarray:
    """The reprojection residuals of N detections: state (N,4) — or
    (N,3) with z_fixed (N,) — -> (N, 7). The keypoint row is zero-masked
    where kpt_u < 0, which contributes nothing to J^T J / J^T r — exactly
    equivalent to omitting it as the reference's scalar solver does."""
    state = np.asarray(state, np.float64)
    if z_fixed is None:
        x, y, z, theta = state[:, 0], state[:, 1], state[:, 2], state[:, 3]
    else:
        x, y, theta = state[:, 0], state[:, 1], state[:, 2]
        z = np.asarray(z_fixed, np.float64)
    h, w, l = (np.asarray(dims, np.float64)[:, i] for i in range(3))
    f, cu, cv, b = calib.f_u, calib.c_u, calib.c_v, calib.baseline
    lu = np.array([1, 1, -1, -1], np.float64)[None] * (l[:, None] / 2.0)
    wv = np.array([1, -1, -1, 1], np.float64)[None] * (w[:, None] / 2.0)
    ct, st = np.cos(theta)[:, None], np.sin(theta)[:, None]
    cx = x[:, None] + lu * ct + wv * st                     # (N, 4)
    cz = z[:, None] - lu * st + wv * ct
    cx8 = np.concatenate([cx, cx], 1)                       # (N, 8)
    cz8 = np.concatenate([cz, cz], 1)
    cy8 = np.concatenate([np.broadcast_to(y[:, None], cx.shape),
                          (y - h)[:, None] + np.zeros_like(cx)], 1)
    zs = np.maximum(cz8, 0.5)
    us = f * cx8 / zs + cu
    vs = f * cy8 / zs + cv
    us_r = f * (cx8 - b) / zs + cu
    bl = np.asarray(box_left, np.float64)
    br = np.asarray(box_right, np.float64)
    n = state.shape[0]
    kcol = us[np.arange(n), np.asarray(kpt_idx, np.int64) % 4]
    kmask = np.asarray(kpt_u, np.float64) >= 0
    res = np.stack([
        us.min(1) - bl[:, 0], vs.min(1) - bl[:, 1],
        us.max(1) - bl[:, 2], vs.max(1) - bl[:, 3],
        us_r.min(1) - br[:, 0], us_r.max(1) - br[:, 2],
        np.where(kmask, kcol - np.asarray(kpt_u, np.float64), 0.0),
    ], axis=1)
    return res


def _batch_gauss_newton(state0, res_fn, n_iter: int = 20,
                        damping: float = 1e-3):
    """Gauss-Newton over N problems at once, each with the reference's
    scalar iteration and stop rule: update first, then stop when the cost
    plateaus or the normal equations go singular. res_fn: (N, n) ->
    (N, 7)."""
    state = np.asarray(state0, np.float64).copy()
    nprob, n = state.shape
    active = np.ones(nprob, bool)
    last_cost = np.full(nprob, np.inf)
    eye = damping * np.eye(n)[None]
    eps = 1e-4
    for _ in range(n_iter):
        if not active.any():
            break
        r = res_fn(state)                                   # (N, 7)
        cost = (r * r).sum(1)
        jac = np.empty((nprob, r.shape[1], n))
        for j in range(n):
            sp = state.copy()
            sp[:, j] += eps
            jac[:, :, j] = (res_fn(sp) - r) / eps
        jtj = np.einsum("nrj,nrk->njk", jac, jac) + eye
        jtr = np.einsum("nrj,nr->nj", jac, r)
        # per-problem singularity == the scalar solver's LinAlgError break
        ok = np.linalg.det(jtj) > 1e-300
        step = np.zeros_like(state)
        if ok.any():
            step[ok] = np.linalg.solve(jtj[ok], jtr[ok][..., None])[..., 0]
        upd = active & ok
        state[upd] -= step[upd]
        conv = np.abs(last_cost - cost) < 1e-8
        last_cost = np.where(upd, cost, last_cost)
        active = upd & ~conv
    final = res_fn(state)
    return state, (final * final).sum(1)


def solve_batch_x_y_z_theta(calib, alphas, dims, boxes_left, boxes_right,
                            kpts):
    """The 3D poses [x, y, z, theta] of N detections, with the
    reference's scalar iteration and stop rule per detection. alphas (N,),
    dims (N,3), boxes (N,4), kpts (N,>=2) rows [u, type, ...] (u < 0
    disables the keypoint residual). Returns (status (N,) int, states (N,4))."""
    alphas = np.asarray(alphas, np.float64)
    dims = np.asarray(dims, np.float64)
    bl = np.asarray(boxes_left, np.float64)
    br = np.asarray(boxes_right, np.float64)
    n = bl.shape[0]
    st0 = np.stack([initial_state(calib, alphas[i], dims[i], bl[i], br[i])
                    for i in range(n)])
    kpt_u = np.asarray(kpts)[:, 0].astype(np.float64) if kpts is not None \
        else np.full(n, -1.0)
    kpt_idx = np.asarray(kpts)[:, 1].astype(np.int64) if kpts is not None \
        else np.zeros(n, np.int64)

    def res(s):
        return _batch_residuals(s, dims, bl, br, kpt_u, kpt_idx, calib)

    state, cost = _batch_gauss_newton(st0, res)
    ok = (np.isfinite(state).all(1) & (state[:, 2] > 0.5)
          & (state[:, 2] < 200.0) & (cost < 1e4))
    return ok.astype(int), state


def solve_batch_x_y_theta(calib, alphas, dims, boxes_left, disparities,
                          kpts):
    """[x, y, theta] of N detections with z fixed by the aligned
    disparity, z = f*b/disparity. Returns (states (N,3), z (N,))."""
    alphas = np.asarray(alphas, np.float64)
    dims = np.asarray(dims, np.float64)
    bl = np.asarray(boxes_left, np.float64)
    disp = np.asarray(disparities, np.float64)
    z = calib.f_u * calib.baseline / np.maximum(disp, 0.5)
    shift = np.stack([disp, np.zeros_like(disp),
                      disp, np.zeros_like(disp)], 1)
    br = bl - shift
    n = bl.shape[0]
    st0 = np.stack([initial_state(calib, alphas[i], dims[i], bl[i], br[i])
                    for i in range(n)])[:, [0, 1, 3]]
    kpt_u = np.asarray(kpts)[:, 0].astype(np.float64) if kpts is not None \
        else np.full(n, -1.0)
    kpt_idx = np.asarray(kpts)[:, 1].astype(np.int64) if kpts is not None \
        else np.zeros(n, np.int64)

    def res(s):
        return _batch_residuals(s, dims, bl, br, kpt_u, kpt_idx, calib,
                                z_fixed=z)

    state, _ = _batch_gauss_newton(st0, res)
    return state, z


def infer_boundary(im_shape, boxes_left: np.ndarray) -> np.ndarray:
    """Fallback border estimate from box overlaps: for each box, the
    visible horizontal span once occluding (closer = larger) boxes in front
    are removed: (N, 2) [left_u, right_u]. A box j occludes box i where
    they overlap in columns and j's bottom edge is lower."""
    n = boxes_left.shape[0]
    out = np.stack([boxes_left[:, 0], boxes_left[:, 2]], axis=1)
    for i in range(n):
        x1, y1, x2, y2 = boxes_left[i, :4]
        for j in range(n):
            if i == j:
                continue
            ox1, oy1, ox2, oy2 = boxes_left[j, :4]
            # j occludes i if it overlaps and its bottom edge is lower
            if oy2 > y2 and not (ox2 <= x1 or ox1 >= x2):
                if ox1 <= x1 < ox2 < x2:
                    out[i, 0] = max(out[i, 0], ox2)
                if x1 < ox1 < x2 <= ox2:
                    out[i, 1] = min(out[i, 1], ox1)
    return out
