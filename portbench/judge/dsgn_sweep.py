"""`correct` of a DSGN PGD sweep (judge.sweep): the attack runs in
255-space on the exact pixels (unit steps, ball 76.5, clip [0, 255]),
so an iterate is whole pixels and its PNG is the iterate itself, cropped
to the frame."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import dsgn as R



def batch(cell, tr, ids, device):
    cfg = R.config(cell.config["model"])
    attack = cell.config["attack"]
    h, w = cfg.input.height, cfg.input.width
    pad = lambda a: R.pad_frame(a, h, w).astype(np.float32)
    rows = [R.boxes3d(tr.cars[tr.pair_of[i]]) for i in ids]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return SimpleNamespace(
        cfg=cfg, crop=tr.left[0].shape[:2],
        clean_l=t(np.stack([pad(tr.left[tr.pair_of[i]]) for i in ids])),
        clean_r=t(np.stack([pad(tr.right[tr.pair_of[i]]) for i in ids])),
        boxes=t(np.stack([r[0] for r in rows])),
        nbox=torch.tensor([r[1] for r in rows], device=device),
        alpha=attack["alpha"], eps=attack["eps"], hi=255.0)


def loss_and_grad(model, b, xl, xr):
    return R.attack_loss_and_grad(model, b.cfg, xl, xr, b.boxes, b.nbox)


def png_pixels(b, x):
    h, w = b.crop
    return x[:, :h, :w].to(torch.uint8).cpu().numpy()
