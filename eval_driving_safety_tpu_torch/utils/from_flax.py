"""Flax -> PyTorch weight bridge for the ported DSGN.

The port's modules carry the Flax model's auto-names, so the map is
mechanical: the path of a leaf joined with "." names the tensor, a
`kernel` leaf becomes `weight` in PyTorch's layout, and every other leaf
(conv `bias`, FrozenBatchNorm `scale`/`bias`/`mean`/`var`) keeps its name.

Kernel layouts by rank:
  5 (3, 3, 3, C, 1) Score3D, DHWIO -> OIDHW
  4 (kh, kw, I, O) 2D conv, HWIO -> OIHW
  3 (3, C, F) (2+1)D depth kernel, kept as it is (the fused kernel's layout)
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_KERNEL_PERM = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 3: (0, 1, 2)}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def dsgn_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays, with or without the top-level
    "params" collection) -> a state dict for models.dsgn.DSGN or any of
    its submodules."""
    tree = params["params"] if "params" in params else params
    sd = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if name == "kernel":
            if arr.ndim not in _KERNEL_PERM:
                raise ValueError(
                    f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            arr, name = arr.transpose(_KERNEL_PERM[arr.ndim]), "weight"
        sd[".".join([*mods, name])] = torch.tensor(arr)
    return sd
