"""Trainer checkpoints: one directory per saved epoch, written with
`torch.save`.

Counterpart of eval_driving_safety_tpu/utils/checkpoint.py, which writes
orbax directories. A checkpoint of the port is the directory `path`
holding `checkpoint.pt`, a dict such as {params, opt_state, epoch} of
tensors and plain Python values, loaded back with `weights_only=True`.
The port also reads the JAX trainers' orbax directories
(`read_trainer_checkpoint`, through utils.orbax_read, without JAX): their
trees keep the Flax layout, which utils.from_flax bridges. It writes only
its own format.
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


def is_orbax_checkpoint(path: str) -> bool:
    """Whether `path` looks like an orbax directory of the JAX package:
    its `_METADATA` and the OCDBT store's root `manifest.ocdbt`."""
    return all(os.path.isfile(os.path.join(path, n))
               for n in ("_METADATA", "manifest.ocdbt"))


def read_trainer_checkpoint(path: str) -> tuple[Any, bool]:
    """(tree, from_orbax) of an epoch directory: the port's
    `checkpoint.pt`, or else the JAX trainers' orbax checkpoint, whose
    tree is in the Flax layout. Raises ValueError, saying what the
    directory lacks, where it is neither."""
    if is_checkpoint(path):
        return restore_checkpoint(path), False
    from eval_driving_safety_tpu_torch.utils.orbax_read import read_orbax
    return read_orbax(path), True


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
