"""KITTI object-detection AP (R40), the official devkit protocol.

Counterpart of eval_driving_safety_tpu/evalap/kitti_ap.py, the
replacement of the `kitti-object-eval-python` tool the reference runs
after attacked inference: 40-point interpolated AP for 2D / BEV / 3D
boxes with the official easy/moderate/hard difficulty gates and DontCare
handling, following evaluate_object.cpp:
  1. a first matching pass (highest-score det above the IoU gate per gt)
     collects true-positive scores,
  2. `getThresholds` samples up to 41 score thresholds at equal recall
     steps from those scores,
  3. statistics are recomputed at EVERY threshold (dets below the
     threshold ignored, matching by max overlap, small-det ignore rules,
     DontCare absorption for the 2D metric),
  4. AP is the zero-padded 41-point average of the monotone precision
     envelope (R40 drops the recall-0 sample).

Host numpy; the rotated BEV IoU goes through ops.rotated on CPU tensors
in float32, the precision of the JAX evaluator's IoU, so every decision
at an IoU gate falls the same way.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from eval_driving_safety_tpu_torch.data.kitti import KittiObject, read_label
from eval_driving_safety_tpu_torch.ops.rotated import rotated_pairwise_iou

# official difficulty gates: (min bbox height, max occlusion, max truncation)
DIFFICULTY_GATES = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}

N_SAMPLE_PTS = 41


@dataclass
class Difficulty:
    name: str = "moderate"

    @property
    def gates(self):
        return DIFFICULTY_GATES[self.name]


def _iou_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) -> (N,M), +0 width convention (modern KITTI eval)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def _bev_boxes(objs: Sequence[KittiObject]) -> np.ndarray:
    """(N,5) rotated boxes in ops.rotated convention (angle = -ry; see
    ops.rotated.kitti_bev_box5)."""
    if not objs:
        return np.zeros((0, 5))
    return np.array([[o.location[0], o.location[2], o.dimensions[1],
                      o.dimensions[2], -o.rotation_y] for o in objs])


def _iou_bev(a_objs, b_objs) -> np.ndarray:
    """(N, M) rotated BEV IoU, computed in float32."""
    a, b = _bev_boxes(a_objs), _bev_boxes(b_objs)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return rotated_pairwise_iou(f32(a), f32(b)).numpy()


def _iou_3d(a_objs, b_objs) -> np.ndarray:
    """BEV rotated IoU x vertical overlap."""
    bev = _iou_bev(a_objs, b_objs)
    if bev.size == 0:
        return bev
    ya = np.array([[o.location[1], o.dimensions[0]] for o in a_objs])
    yb = np.array([[o.location[1], o.dimensions[0]] for o in b_objs])
    # y is the bottom; box spans [y-h, y]
    top = np.minimum(ya[:, None, 0], yb[None, :, 0])
    bot = np.maximum(ya[:, None, 0] - ya[:, None, 1],
                     yb[None, :, 0] - yb[None, :, 1])
    inter_h = np.clip(top - bot, 0, None)
    # recompose: bev gives inter_area/union_area; approximate 3D IoU by
    # scaling overlap heights through the volumes
    a_bev = _bev_boxes(a_objs)
    b_bev = _bev_boxes(b_objs)
    area_a = a_bev[:, 2] * a_bev[:, 3]
    area_b = b_bev[:, 2] * b_bev[:, 3]
    inter_area = bev * (area_a[:, None] + area_b[None, :]) / (1.0 + bev)
    inter_vol = inter_area * inter_h
    vol_a = area_a * ya[:, 1]
    vol_b = area_b * yb[:, 1]
    return inter_vol / np.maximum(
        vol_a[:, None] + vol_b[None, :] - inter_vol, 1e-9)


def _gt_status(objs: Sequence[KittiObject], cls: str, difficulty) -> List[int]:
    """1 = counted gt, 0 = ignored (other difficulty / neighbor class),
    -1 = irrelevant class."""
    min_h, max_occ, max_trunc = difficulty.gates
    out = []
    for o in objs:
        h = o.bbox[3] - o.bbox[1]
        neighbor = (cls == "Car" and o.type == "Van") or \
            (cls == "Pedestrian" and o.type == "Person_sitting")
        if o.type == cls:
            hard = (h < min_h or o.occluded > max_occ
                    or o.truncated > max_trunc)
            out.append(0 if hard else 1)
        elif neighbor:
            out.append(0)       # neighboring class: ignored, never fp
        else:
            out.append(-1)
    return out


class _Image:
    """Per-image matching inputs, precomputed once per metric."""

    __slots__ = ("gts", "dets", "scores", "ious", "gt_status", "det_small",
                 "dontcare", "n_gt")

    def __init__(self, gts, dets, ious, gt_status, det_small, dontcare):
        self.gts = gts
        self.dets = dets
        self.scores = np.asarray([d.score for d in dets], float)
        self.ious = ious
        self.gt_status = gt_status
        self.det_small = det_small
        self.dontcare = dontcare
        self.n_gt = int(sum(1 for s in gt_status if s == 1))


def _first_pass_tp_scores(img: _Image, iou_thresh: float) -> List[float]:
    """Official first matching pass: each counted gt claims the
    HIGHEST-SCORE unassigned det above the IoU gate (overlap quality is
    irrelevant in this pass); returns the claimed scores, which seed the
    recall-threshold sampling."""
    taken = np.zeros(len(img.dets), bool)
    out = []
    for gi, status in enumerate(img.gt_status):
        if status == -1:
            continue
        cand = (~taken) & (img.ious[gi] > iou_thresh)
        if not cand.any():
            continue
        j = int(np.argmax(np.where(cand, img.scores, -np.inf)))
        taken[j] = True
        # only a counted gt matched to a normal-height det yields a TP score
        if status == 1 and not img.det_small[j]:
            out.append(float(img.scores[j]))
    return out


def _stats_at_threshold(img: _Image, iou_thresh: float, thresh: float,
                        compute_aos: bool):
    """Official scoring pass at one score threshold: gt-loop matching by
    max overlap among dets >= thresh, ignore rules, DontCare absorption.
    Returns (tp, fp, similarity_sum)."""
    below = img.scores < thresh
    taken = np.zeros(len(img.dets), bool)
    tp = 0
    sim = 0.0
    for gi, status in enumerate(img.gt_status):
        if status == -1:
            continue
        best_j, best_ov, hit_ignored = -1, 0.0, False
        row = img.ious[gi]
        for j in range(len(img.dets)):
            if taken[j] or below[j] or row[j] <= iou_thresh:
                continue
            if not img.det_small[j] and (row[j] > best_ov or hit_ignored):
                best_j, best_ov, hit_ignored = j, row[j], False
            elif img.det_small[j] and best_j == -1:
                best_j, hit_ignored = j, True
        if best_j == -1:
            continue
        taken[best_j] = True
        if status == 1 and not img.det_small[best_j]:
            tp += 1
            if compute_aos:
                sim += 0.5 * (1.0 + np.cos(img.gts[gi].alpha
                                           - img.dets[best_j].alpha))
    # false positives: unassigned, normal-height, above-threshold dets ...
    fp_mask = (~taken) & (~img.det_small) & (~below)
    # ... minus those mostly inside a DontCare region (2D metric only)
    if img.dontcare is not None and len(img.dontcare) and fp_mask.any():
        dc = np.asarray(img.dontcare, float)
        for j in np.nonzero(fp_mask)[0]:
            bb = img.dets[j].bbox
            ix = np.clip(np.minimum(dc[:, 2], bb[2])
                         - np.maximum(dc[:, 0], bb[0]), 0, None)
            iy = np.clip(np.minimum(dc[:, 3], bb[3])
                         - np.maximum(dc[:, 1], bb[1]), 0, None)
            det_area = max((bb[2] - bb[0]) * (bb[3] - bb[1]), 1e-9)
            if (ix * iy / det_area).max(initial=0.0) > iou_thresh:
                fp_mask[j] = False
    return tp, int(fp_mask.sum()), sim


def _recall_thresholds(tp_scores: Sequence[float], n_gt: int) -> List[float]:
    """Official getThresholds: walk TP scores in descending order, keeping
    the score whose left recall is nearest each 1/(N-1) recall step."""
    v = sorted(tp_scores, reverse=True)
    out, current = [], 0.0
    for i, s in enumerate(v):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(v) - 1 else l_recall
        if (r_recall - current) < (current - l_recall) and i < len(v) - 1:
            continue
        out.append(s)
        current += 1.0 / (N_SAMPLE_PTS - 1.0)
    return out


def _ap_r40(precision_at_thresholds: Sequence[float]) -> float:
    """Zero-padded 41-point average with the monotone envelope, dropping
    the recall-0 sample (the devkit's get_mAP_R40)."""
    prec = np.zeros(N_SAMPLE_PTS)
    k = min(len(precision_at_thresholds), N_SAMPLE_PTS)
    prec[:k] = np.asarray(precision_at_thresholds[:k], float)
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    return float(prec[1:].sum() / (N_SAMPLE_PTS - 1.0))


def evaluate_detections(gt_per_image: Sequence[Sequence[KittiObject]],
                        det_per_image: Sequence[Sequence[KittiObject]],
                        cls: str = "Car", iou_thresh: float = 0.7,
                        difficulty: str = "moderate",
                        metrics: Sequence[str] = ("bbox", "bev", "3d"),
                        ) -> Dict[str, float]:
    """AP (R40) for 2D bbox / BEV / 3D at the given difficulty, via the
    official per-threshold protocol. `metrics` restricts which IoU kinds
    are computed (the rotated BEV/3D IoU is the expensive part on large
    synthetic sets). AOS rides the 2D-bbox matching, per the official
    convention.

    Note the official R40 zero-pads its 41 recall samples: sets with few
    counted gts cannot fill the sweep and report AP << precision by
    design — identical to what the reference's eval tool prints.
    """
    diff = Difficulty(difficulty)
    min_h = diff.gates[0]
    result = {}
    for metric in metrics:
        images = []
        for gts, dets in zip(gt_per_image, det_per_image):
            dets_c = [d for d in dets if d.type == cls]
            status = _gt_status(gts, cls, diff)
            det_small = np.asarray(
                [(d.bbox[3] - d.bbox[1]) < min_h for d in dets_c], bool)
            dontcare = [g.bbox for g in gts if g.type == "DontCare"] \
                if metric == "bbox" else None
            if metric == "bbox":
                ious = _iou_2d(np.asarray([g.bbox for g in gts]).reshape(-1, 4),
                               np.asarray([d.bbox for d in dets_c]).reshape(-1, 4))
            elif metric == "bev":
                ious = _iou_bev(gts, dets_c)
            else:
                ious = _iou_3d(gts, dets_c)
            images.append(_Image(gts, dets_c, ious, status, det_small,
                                 dontcare))
        total_gt = sum(im.n_gt for im in images)
        tp_scores = [s for im in images
                     for s in _first_pass_tp_scores(im, iou_thresh)]
        thresholds = _recall_thresholds(tp_scores, max(total_gt, 1))
        compute_aos = metric == "bbox"
        prec, aos = [], []
        for t in thresholds:
            tp = fp = 0
            sim = 0.0
            for im in images:
                r = _stats_at_threshold(im, iou_thresh, t, compute_aos)
                tp += r[0]
                fp += r[1]
                sim += r[2]
            denom = max(tp + fp, 1)
            prec.append(tp / denom)
            aos.append(sim / denom)
        result[f"ap_{metric}"] = _ap_r40(prec)
        if compute_aos:
            result["ap_aos"] = _ap_r40(aos)
    return result


def evaluate_folders(gt_dir: str, det_dir: str, cls: str = "Car",
                     iou_thresh: float = 0.7,
                     difficulty: str = "moderate") -> Dict[str, float]:
    """Label-folder interface of the reference's eval hook: det txts are
    matched to gt txts by file name; missing det files count as empty."""
    gts, dets = _load_folders(gt_dir, det_dir)
    return evaluate_detections(gts, dets, cls, iou_thresh, difficulty)


# official per-class 3D/BEV IoU thresholds (evaluate_object.cpp)
CLASS_IOU_THRESH = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
DIFFICULTIES = ("easy", "moderate", "hard")


def _load_folders(gt_dir: str, det_dir: str):
    gt_names = sorted(n for n in os.listdir(gt_dir) if n.endswith(".txt"))
    gts, dets = [], []
    for n in gt_names:
        gts.append(read_label(os.path.join(gt_dir, n)))
        dp = os.path.join(det_dir, n)
        dets.append(read_label(dp) if os.path.exists(dp) else [])
    return gts, dets


def evaluate_full_table(gt_per_image, det_per_image,
                        classes: Sequence[str] = ("Car",)) -> Dict[str, Dict]:
    """Full easy/moderate/hard AP table per class, the table the
    reference's eval hook prints.

    Returns {cls: {difficulty: {ap_bbox, ap_aos, ap_bev, ap_3d}}}.
    """
    table: Dict[str, Dict] = {}
    for cls in classes:
        thr = CLASS_IOU_THRESH.get(cls, 0.5)
        table[cls] = {
            d: evaluate_detections(gt_per_image, det_per_image, cls, thr, d)
            for d in DIFFICULTIES}
    return table


def evaluate_folders_full(gt_dir: str, det_dir: str,
                          classes: Sequence[str] = ("Car",)) -> Dict[str, Dict]:
    gts, dets = _load_folders(gt_dir, det_dir)
    return evaluate_full_table(gts, dets, classes)


def format_ap_table(table: Dict[str, Dict]) -> str:
    """Human-readable AP table (AP in %, R40), one class block per line
    group, mirroring the official evaluator's printout."""
    lines = []
    for cls, per_diff in table.items():
        lines.append(f"{cls} AP(%) @ IoU "
                     f"{CLASS_IOU_THRESH.get(cls, 0.5):.2f} (R40):")
        header = "  {:<10}" + "{:>10}" * len(DIFFICULTIES)
        lines.append(header.format("", *DIFFICULTIES))
        for metric, label in (("ap_bbox", "bbox"), ("ap_aos", "aos"),
                              ("ap_bev", "bev"), ("ap_3d", "3d")):
            row = "  {:<10}".format(label) + "".join(
                "{:>10.2f}".format(100.0 * per_diff[d][metric])
                for d in DIFFICULTIES)
            lines.append(row)
    return "\n".join(lines)
