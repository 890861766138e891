"""The sweeps' packed gradient signs, read with the benchmark's own code
(the layout the attack engine documents: 1-bit planes LSB first over a
row's W*3 values, +1 where set and -1 where clear; 2-bit codes s + 1,
four to a byte, LSB first), and the PGD update replayed from them."""
from __future__ import annotations

import numpy as np
import torch


def unpack(packed: np.ndarray, bits: int, width: int) -> np.ndarray:
    """(..., W*3*bits//8) uint8 -> (..., W, 3) int8 signs."""
    p = np.asarray(packed)
    if bits == 1:
        b = np.unpackbits(p[..., None], axis=-1, bitorder="little")
        s = b.reshape(*p.shape[:-1], -1).astype(np.int8) * 2 - 1
    else:
        shifts = np.array([0, 2, 4, 6], np.uint8)
        c = (p[..., None] >> shifts) & 3
        s = c.reshape(*p.shape[:-1], -1).astype(np.int8) - 1
    return s.reshape(*p.shape[:-1], width, 3)


def replay(clean: torch.Tensor, signs, alpha, eps, lo, hi, start=None):
    """Iterates 0..K of x <- clip(clean + clip(x + alpha s - clean, -eps,
    eps), lo, hi), float32, from `start` (the clean frame by default) and
    K sign frames."""
    t = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                  device=clean.device)
    alpha, eps, lo, hi = t(alpha), t(eps), t(lo), t(hi)
    x = clean if start is None else start
    xs = [x]
    for s in signs:
        x = clean + torch.clamp(x + alpha * s - clean, -eps, eps)
        x = torch.clamp(x, lo, hi)
        xs.append(x)
    return xs


def disagree(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a != b).float().mean())


def ascent_lost(g: torch.Tensor, s: torch.Tensor) -> float:
    """The share of a sign step's first-order gain in the loss, alpha *
    sum |g|, that the signs `s` lose against the signs of the gradient `g`:
    (sum |g| - sum s g) / (2 sum |g|); 0 for the gradient's own signs, 1
    for their opposite, 1/2 for signs of no relation to it."""
    g = g.double()
    a = g.abs().sum()
    return float((a - (s.double() * g).sum()) / (2 * a)) if a > 0 else 0.0


def sign_readings(g: torch.Tensor, s: torch.Tensor) -> dict:
    """How far the signs `s` of one frame stray from the signs of the
    reference gradient `g`: the share of values that differ, overall and
    among the 10% and 1% of largest |g|, and `ascent_lost`."""
    ref = torch.sign(g)
    a = g.abs().flatten()
    out = {"sign_disagree": disagree(ref, s),
           "ascent_lost": ascent_lost(g, s)}
    for name, q in (("top10_disagree", 0.9), ("top1_disagree", 0.99)):
        k = max(1, int(round(a.numel() * (1 - q))))
        top = torch.topk(a, k).indices
        out[name] = disagree(ref.flatten()[top], s.flatten()[top])
    return out
