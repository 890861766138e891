"""L-inf PGD (iterated FGSM) with packed-sign trajectories and host replay.

Counterpart of eval_driving_safety_tpu/attack/pgd.py. `pgd_attack` ascends
`loss_fn(im_left, im_right)` w.r.t. both views with a Python loop of
`torch.autograd.grad`; `loss_fn` includes any normalization, so the engine
works purely in attack space.

Sign trajectories: the update is a deterministic function of the clean
pair and the per-iteration gradient signs. `alpha * sign` is an exact f32
product and every other update op (add, sub, clamp) one correctly rounded
f32 op, so replaying the rule on the host from the packed signs
reproduces every device iterate bit-exactly (`replay_pgd`). Where the
iterates lie on a half-integer grid the sweep replays them natively in
doubled integers (attack.replay_native.replay_sweep_u8); its plain
versions here, for the tests, are `replay_pgd_255` (DSGN's 255-space)
and `replay_pgd_ints` (the Stereo R-CNN's integer v-space). The packed
bytes are identical to the JAX package's
(`pack_signs`: four 2-bit codes s+1 per byte, LSB first; `pack_bits`:
LSB-first 1-bit planes), so the on-disk contract and the replay carry over.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_PACK_WEIGHTS = (1, 4, 16, 64)
_B1_WEIGHTS = tuple(1 << i for i in range(8))
_CODES2 = np.stack([(np.arange(256) >> (2 * i)) & 3 for i in range(4)],
                   axis=-1)                                    # (256, 4)
_UNPACK_LUT = _CODES2.astype(np.float32) - 1.0
_UNPACK_LUT_2X = 2 * (_CODES2.astype(np.int16) - 1)           # doubled signs
_UNPACK_LUT_I8 = _CODES2.astype(np.int8) - 1                   # plain signs
_B1_BITS = np.stack([(np.arange(256) >> i) & 1 for i in range(8)],
                    axis=-1).astype(np.uint16)                 # (256, 8)


def _b1_to_code2_lut(ones_code: int, zeros_code: int) -> np.ndarray:
    """(256,) uint16: 8 bits -> eight 2-bit fields (little-endian), set
    bits -> ones_code, clear bits -> zeros_code."""
    fields = np.where(_B1_BITS == 1, ones_code, zeros_code).astype(np.uint16)
    return (fields << (2 * np.arange(8, dtype=np.uint16))).sum(
        axis=-1, dtype=np.uint16)


_LUT_B1_CODE2 = _b1_to_code2_lut(2, 0)      # positive bit: +1 -> 2, -1 -> 0
_LUT_Z_MASK3 = _b1_to_code2_lut(3, 0)       # zero bit forces code 1 (sign 0)
_LUT_Z_CODE1 = _b1_to_code2_lut(1, 0)


def pack_signs(s: torch.Tensor) -> torch.Tensor:
    """(..., W, C) signs in {-1, 0, +1} -> (..., W*C//4) uint8."""
    w, c = s.shape[-2], s.shape[-1]
    if (w * c) % 4 != 0:
        raise ValueError(f"W*C={w * c} not divisible by 4; pad the width")
    code = (s + 1).to(torch.uint8).reshape(*s.shape[:-2], (w * c) // 4, 4)
    weights = torch.tensor(_PACK_WEIGHTS, dtype=torch.uint8, device=s.device)
    return (code * weights).sum(dim=-1).to(torch.uint8)


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """(..., W, C) bool -> (..., W*C//8) uint8, LSB-first 1-bit plane."""
    w, c = b.shape[-2], b.shape[-1]
    if (w * c) % 8 != 0:
        raise ValueError(f"W*C={w * c} not divisible by 8; pad the width")
    code = b.to(torch.uint8).reshape(*b.shape[:-2], (w * c) // 8, 8)
    weights = torch.tensor(_B1_WEIGHTS, dtype=torch.uint8, device=b.device)
    return (code * weights).sum(dim=-1).to(torch.uint8)


def signs1_to_packed2(pos_packed: np.ndarray,
                      zero_packed: Optional[np.ndarray] = None) -> np.ndarray:
    """Host convert of 1-bit sign planes to the 2-bit `pack_signs` codes:
    (..., W*C//8) uint8 -> (..., W*C//4) uint8. Takes arrays of any
    memory layout."""
    p = np.ascontiguousarray(pos_packed)
    code = _LUT_B1_CODE2[p]
    if zero_packed is not None:
        z = np.ascontiguousarray(zero_packed)
        code = (code & ~_LUT_Z_MASK3[z]) | _LUT_Z_CODE1[z]
    # little-endian uint16 -> two LSB-first 2-bit-code bytes
    code = np.ascontiguousarray(code.astype("<u2"))
    return code.view(np.uint8).reshape(*p.shape[:-1], -1)


def unpack_signs(packed: np.ndarray, channels: int = 3) -> np.ndarray:
    """Host inverse of pack_signs: (..., W*C//4) uint8 -> (..., W, C)
    float32 signs."""
    p = np.asarray(packed)
    out = _UNPACK_LUT[p]
    w = p.shape[-1] * 4 // channels
    return out.reshape(*p.shape[:-1], w, channels)


class PGDResult(NamedTuple):
    adv_left: torch.Tensor     # (B, H, W, 3) final attacked pair
    adv_right: torch.Tensor
    losses: torch.Tensor       # (num_iters,) loss per iteration
    trajectory: Optional[tuple]
    # collect=True:     ((iters, B, H, W, 3) f32, same) full iterates
    # collect="signs":  ((iters, B, H, W*3//4) u8, same) packed signs
    # collect="signs1": per side (pos_plane (iters,B,H,W*3//8) u8,
    #                   zero_plane same, nzeros (iters,) i64)


def pgd_attack(loss_fn: Callable, clean_left: torch.Tensor,
               clean_right: torch.Tensor, *, num_iters: int, alpha, eps,
               clip_min, clip_max, collect=False,
               sign_only: bool = True) -> PGDResult:
    """L-inf PGD ascent on `loss_fn` w.r.t. both views jointly.

    clip_min/clip_max broadcast against (B, H, W, 3). collect=True stacks
    full iterates; "signs" stacks 2-bit packed gradient signs; "signs1"
    splits each iteration's signs into a positive and a zero 1-bit plane
    plus a zero count, so the host needs the zero plane only when a
    gradient was exactly zero."""
    if collect in ("signs", "signs1") and not sign_only:
        raise ValueError(f"collect={collect!r} requires sign_only=True")
    kw = dict(dtype=clean_left.dtype, device=clean_left.device)
    alpha, eps = torch.as_tensor(alpha, **kw), torch.as_tensor(eps, **kw)
    clip_min = torch.as_tensor(clip_min, **kw)
    clip_max = torch.as_tensor(clip_max, **kw)

    def project(x, clean):
        x = clean + torch.clamp(x - clean, -eps, eps)
        return torch.clamp(x, clip_min, clip_max)

    xl, xr = clean_left, clean_right
    losses, steps = [], []
    for _ in range(num_iters):
        vl = xl.detach().requires_grad_(True)
        vr = xr.detach().requires_grad_(True)
        loss = loss_fn(vl, vr)
        gl, gr = torch.autograd.grad(loss, (vl, vr))
        if sign_only:
            gl, gr = torch.sign(gl), torch.sign(gr)
        xl = project(xl + alpha * gl, clean_left)
        xr = project(xr + alpha * gr, clean_right)
        losses.append(loss.detach())
        if collect == "signs":
            steps.append((pack_signs(gl), pack_signs(gr)))
        elif collect == "signs1":
            steps.append(tuple((pack_bits(g > 0), pack_bits(g == 0),
                                torch.sum(g == 0)) for g in (gl, gr)))
        elif collect:
            steps.append((xl, xr))
    losses = torch.stack(losses) if losses else torch.zeros(0, **kw)
    traj = None
    if collect == "signs1":
        traj = tuple(tuple(torch.stack([s[side][j] for s in steps])
                           for j in range(3)) for side in (0, 1))
    elif collect:
        traj = tuple(torch.stack([s[side] for s in steps])
                     for side in (0, 1))
    return PGDResult(xl, xr, losses, traj)


def replay_pgd(clean_left: np.ndarray, clean_right: np.ndarray,
               packed_left: np.ndarray, packed_right: np.ndarray, *,
               alpha, eps, clip_min, clip_max):
    """Host replay of the PGD update from 2-bit packed signs. Yields
    (iter_left, iter_right) float32 pairs for iterations 1..N, each
    bit-identical to the device iterate."""
    alpha = np.asarray(alpha, np.float32)
    eps = np.asarray(eps, np.float32)
    clip_min = np.asarray(clip_min, np.float32)
    clip_max = np.asarray(clip_max, np.float32)
    xl = np.asarray(clean_left, np.float32)
    xr = np.asarray(clean_right, np.float32)
    cl, cr = xl, xr
    ch = xl.shape[-1]
    for k in range(np.asarray(packed_left).shape[0]):
        sl = unpack_signs(packed_left[k], channels=ch)
        sr = unpack_signs(packed_right[k], channels=ch)
        xl = np.clip(cl + np.clip((xl + alpha * sl) - cl, -eps, eps),
                     clip_min, clip_max).astype(np.float32)
        xr = np.clip(cr + np.clip((xr + alpha * sr) - cr, -eps, eps),
                     clip_min, clip_max).astype(np.float32)
        yield xl, xr


def replay_255_valid(alpha, eps, clip_min, clip_max) -> bool:
    """True when the integer replay (`replay_pgd_255`) is exact for a
    255-space attack: unit step, half-integer ball, full pixel range."""
    try:
        return (float(alpha) == 1.0 and float(2 * eps).is_integer()
                and float(clip_min) == 0.0 and float(clip_max) == 255.0)
    except (TypeError, ValueError):
        return False


def replay_pgd_255(clean_u8_left: np.ndarray, clean_u8_right: np.ndarray,
                   packed_left: np.ndarray, packed_right: np.ndarray, *,
                   eps: float):
    """Integer replay of a 255-space attack (alpha 1, clip [0, 255], clean
    = exact uint8 pixels). Device iterates are half-integers, tracked here
    doubled in int16. Yields truncated (u8_left, u8_right) frames per
    iteration, equal to running `replay_pgd` in f32 and truncating."""
    e2 = int(round(2 * float(eps)))
    c2l = clean_u8_left.astype(np.int16) << 1
    c2r = clean_u8_right.astype(np.int16) << 1
    v2l, v2r = c2l, c2r
    ch = clean_u8_left.shape[-1]
    pl = np.asarray(packed_left)
    pr = np.asarray(packed_right)

    def unpack2x(p):
        out = _UNPACK_LUT_2X[p]
        return out.reshape(*p.shape[:-1], p.shape[-1] * 4 // ch, ch)

    for k in range(pl.shape[0]):
        v2l = np.clip(np.clip(v2l + unpack2x(pl[k]) - c2l, -e2, e2) + c2l,
                      0, 510)
        v2r = np.clip(np.clip(v2r + unpack2x(pr[k]) - c2r, -e2, e2) + c2r,
                      0, 510)
        yield ((v2l >> 1).astype(np.uint8), (v2r >> 1).astype(np.uint8))


def srcnn_replay_intable(a_pix, e_pix, K) -> bool:
    """True when the doubled-integer replay (`replay_pgd_ints`) is exact
    for a v-space attack with per-sample scale K = den_h * den_w (clean
    values K * 255 * bgr01, exact integers).

    Every f32 value the device makes must be exact. With alpha_v =
    a_pix * K and eps_v = e_pix * K both integers, the iterates, deltas
    and bounds lie on the integer grid, exact below 2^24; with
    half-integers (only the doubled values integral) the grid halves and
    the bound is 2^23. The largest value that must be exact is
    max((255 + a_pix) * K, e_pix * K): the step x + alpha * sign before
    the clamp, and the ball's radius. clean + eps may pass the bound, but
    only where it also passes clip_max = 255 * K, whose clamp absorbs its
    rounding. At K = 16 * 3974 = 63584 (KITTI frames at 600 rows), alpha
    1 and eps 76.5 pass the 2^24 bound."""
    K = np.asarray(K, np.float64)
    a2 = np.asarray(2.0 * a_pix * K)
    e2 = np.asarray(2.0 * e_pix * K)
    a2r, e2r = np.rint(a2), np.rint(e2)
    if not (np.all(a2 == a2r) and np.all(e2 == e2r)):
        return False
    even = bool(np.all(a2r % 2 == 0) and np.all(e2r % 2 == 0))
    lim = 2.0 ** 24 if even else 2.0 ** 23
    return float(np.maximum((255.0 + a_pix) * K, e_pix * K).max()) < lim


def replay_pgd_ints(clean2_left: np.ndarray, clean2_right: np.ndarray,
                    packed_left: np.ndarray, packed_right: np.ndarray, *,
                    alpha2, eps2, clip_max2):
    """Doubled-integer replay of a v-space attack where
    `srcnn_replay_intable` holds: every device iterate lies on the
    half-integer grid, so the trajectory is tracked as doubled int32
    values. clean2 = 2 * clean (int32); alpha2, eps2, clip_max2 doubled,
    scalars or (B,) arrays. Yields (v2_left, v2_right) int32 per
    iteration; v2 / 2 is the device's f32 iterate exactly."""
    def bshape(v):
        a = np.asarray(v, np.int32)
        return a.reshape(-1, 1, 1, 1) if a.ndim == 1 else a

    a2, e2, m2 = bshape(alpha2), bshape(eps2), bshape(clip_max2)
    c2l = np.asarray(clean2_left, np.int32)
    c2r = np.asarray(clean2_right, np.int32)
    v2l, v2r = c2l, c2r
    ch = c2l.shape[-1]
    pl, pr = np.asarray(packed_left), np.asarray(packed_right)

    def unpack_sign(p):
        out = _UNPACK_LUT_I8[p]
        return out.reshape(*p.shape[:-1], p.shape[-1] * 4 // ch, ch)

    for k in range(pl.shape[0]):
        v2l = np.clip(np.clip(v2l + unpack_sign(pl[k]) * a2 - c2l, -e2, e2)
                      + c2l, 0, m2)
        v2r = np.clip(np.clip(v2r + unpack_sign(pr[k]) * a2 - c2r, -e2, e2)
                      + c2r, 0, m2)
        yield v2l, v2r
