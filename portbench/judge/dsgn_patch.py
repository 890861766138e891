"""The DSGN adapter of the universal-patch judge (judge.patch): the
reference, the placements the CLI draws, the composite and the loss
toward the targeted ghost car."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dsgn as R

# PatchConfig of the port: the ghost car (h, w, l, x, y, z, ry), the
# placement bands and the right view's shift
GHOST = (1.65, 1.67, 3.64, -0.78, 1.98, 29.11, -1.60)
ROW_BAND, COL_BAND, SHIFT = (0.4, 1.0), (0.2, 0.8), -64


def centers(seed, batch_index, n, h, w, radius):
    """The placements the CLI draws for batch `batch_index` of epoch 0:
    rows and columns from a CPU generator seeded by
    SeedSequence([seed, 0, batch_index]), both bounds inclusive."""
    s = np.random.SeedSequence([seed, 0, batch_index])
    g = torch.Generator().manual_seed(int(s.generate_state(1)[0]))
    row_lo, row_hi = int(h * ROW_BAND[0]), h - radius - 1
    rows = torch.randint(row_lo, max(row_hi, row_lo) + 1, (n,), generator=g)
    col_lo, col_hi = int(w * COL_BAND[0]), int(w * COL_BAND[1])
    cols = torch.randint(col_lo, max(col_hi, col_lo) + 1, (n,), generator=g)
    return (torch.stack([rows, cols], -1),
            torch.stack([rows, cols + SHIFT], -1))


def circle(d, device):
    r = d // 2
    yy, xx = np.mgrid[:d, :d]
    return torch.from_numpy(((yy - r) ** 2 + (xx - r) ** 2 <= r * r)
                            .astype(np.float32)[..., None]).to(device)


def composite(img, patch, center):
    """(H, W, 3) image with the circular (d, d, 3) patch at (row, col),
    clipped at the border."""
    d = patch.shape[0]
    r = d // 2
    h, w, _ = img.shape
    row, col = int(center[0]), int(center[1])
    vis = float(-r <= row <= h - 1 + r and -r <= col <= w - 1 + r)
    m = circle(d, img.device) * vis
    padded = img.new_zeros((h + 4 * r, w + 4 * r, 3))
    padded[2 * r:2 * r + h, 2 * r:2 * r + w] = img
    y0 = min(max(row + r, 0), h + 2 * r - 1)
    x0 = min(max(col + r, 0), w + 2 * r - 1)
    win = padded[y0:y0 + d, x0:x0 + d]
    padded[y0:y0 + d, x0:x0 + d] = (1.0 - m) * win + m * patch
    return padded[2 * r:2 * r + h, 2 * r:2 * r + w]


def ref_gradient(model, cfg, il01, ir01, patch, cl, cr):
    """The loss toward the ghost car and its gradient w.r.t. the patch,
    each row's taken on its own copy and summed in row order."""
    dev = il01.device
    mean = torch.tensor(cfg.input.mean, device=dev)
    std = torch.tensor(cfg.input.std, device=dev)
    rows = [patch.detach().clone().requires_grad_(True)
            for _ in range(il01.shape[0])]
    xl = torch.stack([composite(im, p, c) for im, p, c in zip(il01, rows, cl)])
    xr = torch.stack([composite(im, p, c) for im, p, c in zip(ir01, rows, cr)])
    n = il01.shape[0]
    h, w, l, x, y, z, ry = GHOST
    boxes = torch.zeros(n, 16, 8, device=dev)
    boxes[:, 0] = torch.tensor([x, y, z, h, w, l, ry, 1.0])
    out = model((xl - mean) / std, (xr - mean) / std,
                *R.calib_vectors(n, dev))
    loss = R.total_loss(out, torch.zeros(xl.shape[:3], device=dev), boxes,
                        torch.ones(n, dtype=torch.long, device=dev), cfg)
    gs = torch.autograd.grad(loss, rows)
    g = gs[0]
    for more in gs[1:]:
        g = g + more
    return g


def images(tr, ids, cfg, device):
    h, w = cfg.input.height, cfg.input.width
    pad = lambda a: R.pad_frame(a, h, w).astype(np.float32) / 255.0
    t = lambda side: torch.from_numpy(np.stack(
        [pad(side[tr.pair_of[i]]) for i in ids]).astype(np.float32)) \
        .to(device)
    return t(tr.left), t(tr.right)
