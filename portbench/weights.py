"""Seeded weights, made on the device in a few large calls and saved as
the state-dict file that the CLI takes as `--ckpt` and the reference
loads."""
from __future__ import annotations

import math
import os

import torch


def make_state_dict(shapes, seed: int, device) -> dict:
    """`shapes`: (name, shape, kind) of every tensor (a reference's
    `init_shapes`). Kernels are one normal draw from a generator on
    `device` seeded with `seed`, clipped to +-2 and scaled to variance
    1 / fan-in; constants are filled. float32, as the port keeps
    parameters."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    kernels = [(n, s, k[1]) for n, s, k in shapes if k[0] == "kernel"]
    total = sum(math.prod(s) for _, s, _ in kernels)
    flat = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    sd, pos = {}, 0
    for name, shape, fan_in in kernels:
        n = math.prod(shape)
        sd[name] = flat[pos:pos + n].view(shape).mul_(
            1.0 / (0.87962566 * math.sqrt(fan_in)))
        pos += n
    for name, shape, kind in shapes:
        if kind[0] == "const":
            sd[name] = torch.full(shape, float(kind[1]), device=device)
    return {name: sd[name] for name, _, _ in shapes}


def save(sd: dict, path: str) -> int:
    """Write `sd` with torch.save (host copies); returns the bytes."""
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    return os.path.getsize(path)
