"""Fixed-size rotated (BEV) NMS, batched over images.

Counterpart of the rotated half of eval_driving_safety_tpu/ops/nms.py:
every call returns `max_out` kept indices per image and a validity mask,
so no shape depends on the data. The parallel form iterates the greedy
keep mask to its fixpoint on the device and reads one flag back every
`CHECK_EVERY` steps to stop; `host_syncs` counts those reads.
"""
from __future__ import annotations

import torch

from eval_driving_safety_tpu_torch.ops.rotated import rotated_pairwise_iou

NEG_INF = -1e10
# fixpoint steps between two convergence checks (host syncs)
CHECK_EVERY = 4

host_syncs = {"nms_fixpoint": 0}


def _nms_from_iou(iou, scores, valid, max_out: int, iou_thresh: float):
    """Greedy NMS given (B, N, N) IoUs: `max_out` steps, each keeping the
    best live box (the first on ties) and suppressing every box over the
    threshold with it. Returns (keep_idx (B, max_out), keep_mask)."""
    live = torch.where(valid, scores, NEG_INF)
    rows = torch.arange(scores.shape[0], device=scores.device)
    idx, ok = [], []
    for _ in range(max_out):
        best = torch.argmax(live, dim=-1)                      # (B,)
        ok.append(live[rows, best] > NEG_INF / 2)
        sup = iou[rows, best] > iou_thresh                     # (B, N)
        live = torch.where(sup, NEG_INF, live)
        # always suppress the selected box itself
        live = live.scatter(-1, best[:, None], NEG_INF)
        idx.append(best)
    return torch.stack(idx, -1), torch.stack(ok, -1)


def _keep_fixpoint(iou, scores, valid, iou_thresh: float):
    """(B, N) keep mask of greedy NMS as the fixpoint of "a box survives
    iff no surviving higher-ranked box overlaps it over the threshold".
    Ranks come from a stable descending sort (ties: lower index first).
    The dominance graph is acyclic in rank, so the iteration reaches the
    greedy solution in (suppression chain depth) steps; like the JAX
    version it stops there, or after n steps."""
    n = scores.shape[-1]
    scores = torch.where(valid, scores, NEG_INF)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    rank = torch.argsort(order, dim=-1)                # rank[i]: position
    # dom[b, i, j]: j (higher rank) can suppress i
    higher = rank[..., None, :] < rank[..., :, None]
    dom = (iou > iou_thresh) & higher & valid[..., None, :] \
        & valid[..., :, None]

    def step(keep):
        suppressed = (dom & keep[..., None, :]).any(-1)
        return valid & ~suppressed

    prev = step(valid)
    keep = step(prev)
    done = 0
    while done < n:
        host_syncs["nms_fixpoint"] += 1
        if torch.equal(keep, prev):
            break
        for _ in range(min(CHECK_EVERY, n - done)):
            prev, keep = keep, step(keep)
            done += 1
    return keep


def top_k_stable(values, k: int):
    """The k largest of each row, ties lower index first (lax.top_k's
    order): the head of a stable descending sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rotated_nms(boxes5, scores, max_out: int, iou_thresh: float, valid=None,
                parallel: bool = True):
    """Rotated (BEV) NMS over (B, N, 5) boxes (cx, cy, w, l, angle) and
    (B, N) scores -> (keep_idx (B, max_out), keep_mask (B, max_out)).

    The greedy-equivalent parallel fixpoint by default (`_keep_fixpoint`);
    `parallel=False` runs the sequential greedy steps."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    iou = rotated_pairwise_iou(boxes5, boxes5)
    if not parallel:
        return _nms_from_iou(iou, scores, valid, max_out, iou_thresh)
    keep = _keep_fixpoint(iou, scores, valid, iou_thresh)
    masked = torch.where(keep, scores, NEG_INF)
    vals, idx = top_k_stable(masked, max_out)
    return idx, vals > NEG_INF / 2
