"""Trainer checkpoints: one directory per saved epoch, written with
`torch.save`.

Counterpart of eval_driving_safety_tpu/utils/checkpoint.py, which writes
orbax directories; those are not read here. A checkpoint is the directory
`path` holding `checkpoint.pt`, a dict such as {params, opt_state, epoch}
of tensors and plain Python values, loaded back with `weights_only=True`.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

FILE = "checkpoint.pt"


def save_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` into the directory `path` (created, or overwritten)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, FILE))


def restore_checkpoint(path: str) -> Any:
    """Load what `save_checkpoint` wrote into `path`, tensors on the CPU."""
    return torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=True)


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, FILE))


def latest_epoch_dir(base_dir: str, prefix: str = "epoch") -> Optional[str]:
    """The `{prefix}N` directory in `base_dir` with the highest N, or None."""
    if not os.path.isdir(base_dir):
        return None
    best, best_n = None, -1
    for name in os.listdir(base_dir):
        if name.startswith(prefix):
            try:
                n = int(name[len(prefix):])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(base_dir, name), n
    return best
