"""`correct` of a Stereo R-CNN PGD sweep (judge.sweep): the attack runs
in the integer v-space of the exact resize to the network's rows (v =
K * BGR pixel, K = den_h * den_w), with step and ball in pixels times
K, clip [0, 255 K]; a PNG holds the iterate times 1 / K in float32,
clipped and truncated, RGB, at the network's size."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import srcnn as R



def batch(cell, tr, ids, device):
    cfg = R.config(cell.config["model"])
    attack = cell.config["attack"]
    vl, vr, ks, nws, scales = [], [], [], [], []
    for i in ids:
        a, k, nw = R.clean_v(tr.left[tr.pair_of[i]], cfg)
        c, _, _ = R.clean_v(tr.right[tr.pair_of[i]], cfg)
        vl.append(a)
        vr.append(c)
        ks.append(k)
        nws.append(nw)
        scales.append(float(np.float32(cfg.input.height
                                       / tr.left[tr.pair_of[i]].shape[0])))
    K = np.asarray(ks, np.float64)
    col = lambda v: torch.from_numpy(
        (v * K).astype(np.float32).reshape(-1, 1, 1, 1)).to(device)
    t = lambda a: torch.from_numpy(np.stack(a)).to(device)
    model_draws = None
    return SimpleNamespace(
        cfg=cfg, crop=(cfg.input.height, max(nws)), nw=nws,
        clean_l=t(vl), clean_r=t(vr),
        c255=torch.from_numpy((1.0 / K).astype(np.float32)).to(device),
        gt=R.gt_batch([tr.cars[tr.pair_of[i]] for i in ids], scales, cfg,
                      device),
        draws=model_draws, n=len(ids), device=device,
        alpha=col(attack["alpha_px"]), eps=col(attack["eps_px"]),
        hi=col(255.0), uncert=torch.zeros(6, device=device))


def loss_and_grad(model, b, xl, xr):
    if b.draws is None:
        b.draws = model.draws(b.n, b.device)
    return R.attack_loss_and_grad(model, b.cfg, xl, xr, b.c255, b.gt,
                                  b.draws, b.uncert)


def png_pixels(b, x):
    q = torch.clamp(x * b.c255[:, None, None, None], 0, 255).to(torch.uint8)
    q = q.flip(-1).cpu().numpy()
    return [q[j, :, :b.nw[j]] for j in range(q.shape[0])]
