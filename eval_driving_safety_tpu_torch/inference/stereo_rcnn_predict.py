"""Stereo R-CNN detections -> 3D boxes -> KITTI detection dicts.

Counterpart of eval_driving_safety_tpu/inference/stereo_rcnn_predict.py,
with its order of operations: per class, the score threshold (0.05)
masks the rois; greedy NMS (0.4, at most 50 kept) runs over the full
fixed roi set; the kept boxes, keypoints and borders go back to the
original resolution; `infer_boundary` replaces borders narrower than
half its estimate; a batched Gauss-Newton solve gives the 3D pose;
dense alignment refines the disparity at network scale; a second solve
with that disparity gives the exported pose, for the alignment's
successes only.

Where each step runs: the model's `mode="infer"` outputs come to the
host in one transfer per batch (`fetch_outputs`); the box decode, NMS
and the solves run there, on CPU tensors and numpy f64. The alignment
runs on the device that holds the network-scale images, with
one small upload and one fetch per class and frame.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.ops import boxes as B
from eval_driving_safety_tpu_torch.ops.box_solver import (
    infer_boundary, solve_batch_x_y_theta, solve_batch_x_y_z_theta)
from eval_driving_safety_tpu_torch.ops.dense_align import align_disparities
from eval_driving_safety_tpu_torch.ops.nms import nms

CLASS_NAMES = ("__background__", "Car")


class HostOutputs(NamedTuple):
    """The fields of StereoRCNNOutputs that the decode reads, as numpy
    arrays on the host: rois (B, R, 4) without the batch column,
    roi_valid (B, R) bool, the rest float32 as the model gives them."""
    rois_left: np.ndarray
    rois_right: np.ndarray
    roi_valid: np.ndarray
    cls_prob: np.ndarray
    bbox_pred: np.ndarray
    dim_orien_pred: np.ndarray
    kpts_prob: np.ndarray
    left_border_prob: np.ndarray
    right_border_prob: np.ndarray


def fetch_outputs(out) -> HostOutputs:
    """A batch's `mode="infer"` outputs -> HostOutputs in one transfer:
    the fields travel packed as one (B, R, F) float32 tensor."""
    fields = [out.rois_left[..., 1:5], out.rois_right[..., 1:5],
              out.roi_valid[..., None], out.cls_prob, out.bbox_pred,
              out.dim_orien_pred, out.kpts_prob, out.left_border_prob,
              out.right_border_prob]
    widths = [f.shape[-1] for f in fields]
    host = torch.cat([f.float() for f in fields], dim=-1).cpu().numpy()
    parts = np.split(host, np.cumsum(widths)[:-1], axis=-1)
    parts[2] = parts[2][..., 0] > 0.5
    return HostOutputs(*parts)


def decode_kpts(boxes_left: np.ndarray, kpts_prob: np.ndarray,
                lb_prob: np.ndarray, rb_prob: np.ndarray,
                grid: int) -> np.ndarray:
    """(R, 4) boxes and the keypoint head's probabilities -> (R, 5) [u,
    type, prob, left_u, right_u]: each argmax bin's centre (the first bin
    on ties) mapped back to an image column within its roi."""
    x1 = boxes_left[:, 0]
    w = np.maximum(boxes_left[:, 2] - x1 + 1.0, 1.0)

    def bin_to_u(b):
        return x1 + (b + 0.5) * w / grid

    flat = np.argmax(kpts_prob, axis=1)
    kpt_type = flat // grid
    kpt_u = bin_to_u(flat % grid)
    prob = kpts_prob[np.arange(len(flat)), flat]
    lb = bin_to_u(np.argmax(lb_prob, axis=1))
    rb = bin_to_u(np.argmax(rb_prob, axis=1))
    return np.stack([kpt_u, kpt_type.astype(np.float64), prob, lb, rb],
                    axis=1)


def _decode(rois, deltas):
    """ops.boxes.decode_boxes on the host, float32."""
    return B.decode_boxes(torch.tensor(rois, dtype=torch.float32),
                          torch.tensor(deltas, dtype=torch.float32))


def predict_image(outputs, im_left, im_right, calib, cfg: StereoRCNNConfig,
                  image_hw=None, batch_index: int = 0,
                  image_scale: float = 1.0) -> List[Dict]:
    """Row `batch_index` of a batch's outputs -> KITTI detection dicts.

    outputs: HostOutputs (or anything whose fields index as arrays, the
    rois with or without their batch column). im_left/im_right: (H, W, 3)
    float32 tensors in the model's pixel convention at network scale,
    read by the dense alignment only, which runs on the images' device;
    None for both skips the alignment. `image_hw` is the original
    (pre-resize) size and
    `image_scale` the network / original scale: boxes and keypoints go
    back to the original resolution before the 3D solve, whose
    calibration is the original's."""
    i = batch_index
    scores = np.asarray(outputs.cls_prob[i])                 # (R, C)
    boxes_l = np.asarray(outputs.rois_left[i])[:, -4:]
    boxes_r = np.asarray(outputs.rois_right[i])[:, -4:]
    valid = np.asarray(outputs.roi_valid[i]).astype(bool)
    bbox_pred = np.asarray(outputs.bbox_pred[i])             # (R, 6C)
    dim_orien = np.asarray(outputs.dim_orien_pred[i])        # (R, 5C)
    kpts_prob = np.asarray(outputs.kpts_prob[i])
    lb_prob = np.asarray(outputs.left_border_prob[i])
    rb_prob = np.asarray(outputs.right_border_prob[i])

    h_img, w_img = image_hw or (cfg.input.height, cfg.input.width)
    h_net, w_net = cfg.input.height, cfg.input.width
    stds = np.asarray(cfg.bbox_normalize_stds)
    stds6 = np.concatenate([stds, stds[[0]], stds[[2]]])
    means = np.asarray(cfg.bbox_normalize_means)
    means6 = np.concatenate([means, means[[0]], means[[2]]])

    kpts_all = decode_kpts(boxes_l, kpts_prob, lb_prob, rb_prob,
                           cfg.kpts_grid)

    detections: List[Dict] = []
    for j in range(1, cfg.num_classes):
        cls_scores = scores[:, j] * valid
        keep0 = cls_scores > cfg.score_thresh
        if not keep0.any():
            continue
        d6 = bbox_pred.reshape(-1, cfg.num_classes, 6)[:, j] * stds6 + means6
        left = _decode(boxes_l, d6[:, :4])
        d_r = np.stack([d6[:, 4], d6[:, 1], d6[:, 5], d6[:, 3]], axis=1)
        right = _decode(boxes_r, d_r)
        left = B.clip_boxes(left, h_net, w_net)
        right = B.clip_boxes(right, h_net, w_net).numpy()
        do5 = dim_orien.reshape(-1, cfg.num_classes, 5)[:, j]

        # NMS over the full fixed roi set, the rows under the threshold
        # masked: the keep set of subsetting first
        keep_idx, keep_mask = nms(
            left[None], torch.from_numpy(np.asarray(cls_scores,
                                                    np.float32))[None],
            cfg.max_detections, cfg.test_nms_thresh,
            valid=torch.from_numpy(keep0)[None])
        left = left.numpy()
        sel = keep_idx[0][keep_mask[0]].numpy()
        if sel.size == 0:
            continue

        # to the original resolution before the geometry
        cls_left = left[sel] / image_scale
        cls_right = right[sel] / image_scale
        cls_sc = cls_scores[sel]
        cls_do = do5[sel]
        cls_kpts = kpts_all[sel].copy()
        cls_kpts[:, [0, 3, 4]] /= image_scale      # u-coordinate columns

        # borders narrower than half the occlusion estimate take it
        inferred = infer_boundary((h_img, w_img), cls_left)
        narrow = (cls_kpts[:, 4] - cls_kpts[:, 3]) < \
            0.5 * (inferred[:, 1] - inferred[:, 0])
        cls_kpts[narrow, 3:5] = inferred[narrow]

        alphas = np.arctan2(cls_do[:, 3], cls_do[:, 4])
        status, states = solve_batch_x_y_z_theta(
            calib, alphas, cls_do[:, :3], cls_left, cls_right, cls_kpts)
        sel_rows = np.where(status > 0)[0]
        if sel_rows.size == 0:
            continue

        if im_left is not None:
            init_disp = calib.f_u * calib.baseline / np.maximum(
                states[sel_rows, 2], 0.5)

            def put(a):
                return torch.from_numpy(np.asarray(a, np.float32)).to(
                    im_left.device)
            # the photometric alignment samples the network-scale images
            ok, disp = align_disparities(
                im_left, im_right,
                put(cls_left[sel_rows] * image_scale),
                put(cls_kpts[sel_rows][:, 3:5] * image_scale),
                put(init_disp * image_scale))
            res = torch.stack([ok.float(), disp]).cpu().numpy()
            ok = res[0] > 0.5
            disp = res[1] / image_scale
            # only the alignment's successes are exported
            rows = sel_rows[ok]
            if rows.size == 0:
                continue
            st3, z3 = solve_batch_x_y_theta(
                calib, alphas[rows], cls_do[rows, :3], cls_left[rows],
                disp[ok], cls_kpts[rows])
            for m, k in enumerate(rows):
                detections.append(_det_dict(
                    j, cls_left[k], cls_do[k, :3],
                    (float(st3[m, 0]), float(st3[m, 1]), float(z3[m])),
                    float(st3[m, 2]), float(cls_sc[k])))
        else:
            for k in sel_rows:
                st = states[k]
                detections.append(_det_dict(
                    j, cls_left[k], cls_do[k, :3],
                    tuple(float(v) for v in st[:3]), float(st[3]),
                    float(cls_sc[k])))
    return detections


def _det_dict(cls_j, box_left, dims, xyz, theta, score) -> Dict:
    return {
        "type": CLASS_NAMES[cls_j % len(CLASS_NAMES)],
        "bbox": np.asarray(box_left[:4], np.float64),
        "dimensions": (float(dims[0]), float(dims[1]), float(dims[2])),
        "location": xyz,
        "rotation_y": theta,
        "score": score,
    }
