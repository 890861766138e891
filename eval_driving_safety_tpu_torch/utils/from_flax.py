"""Flax -> PyTorch weight bridge for the ported DSGN, Stereo R-CNN and
scene classifiers.

The port's modules carry the Flax model's auto-names, so the map is
mechanical: the path of a leaf joined with "." names the tensor, a
`kernel` leaf becomes `weight` in PyTorch's layout, and every other leaf
(conv `bias`, FrozenBatchNorm `scale`/`bias`/`mean`/`var`) keeps its name.

DSGN and classifier kernel layouts, by rank:
  5 (3, 3, 3, C, 1) Score3D, DHWIO -> OIDHW
  4 (kh, kw, I, O) 2D conv, HWIO -> OIHW
  3 (3, C, F) (2+1)D depth kernel, kept as it is (the fused kernel's layout)
  2 (I, O) Dense -> (O, I)
Stereo R-CNN kernels, by the port module that takes them: a Dense's (I, O)
-> (O, I); a ConvTranspose's (kh, kw, I, O) -> (I, O, kh, kw) flipped in
both spatial axes (models.common.ConvTranspose); a conv's HWIO -> OIHW.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_KERNEL_PERM = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 3: (0, 1, 2),
                2: (1, 0)}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def dsgn_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays, with or without the top-level
    "params" collection) -> a state dict for models.dsgn.DSGN or any of
    its submodules; kernels laid out by their rank."""
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


def stereo_rcnn_state_dict_from_flax(variables: Mapping,
                                     model: nn.Module
                                     ) -> Dict[str, torch.Tensor]:
    """Flax variables of the JAX StereoRCNN (with or without the
    top-level "params" collection; its "constants" anchor table is
    skipped: the port computes its own) -> a state dict for `model`, a
    models.stereo_rcnn.StereoRCNN, each kernel laid out for the port
    module at its path."""
    from eval_driving_safety_tpu_torch.models.common import (ConvTranspose,
                                                             Dense)
    tree = variables["params"] if "params" in variables else variables
    sd = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if name == "kernel":
            mod = model.get_submodule(".".join(mods))
            if isinstance(mod, Dense):
                arr = arr.T
            elif isinstance(mod, ConvTranspose):
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                arr = arr.transpose(_KERNEL_PERM[4])
            name = "weight"
        sd[".".join([*mods, name])] = torch.tensor(
            np.ascontiguousarray(arr))
    return sd


def road_type_state_dict_from_flax(variables: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """Flax variables of the JAX RoadTypeClassifier (`ResNet_0/...`,
    `head`) -> a state dict for models.classifiers.RoadTypeClassifier."""
    return dsgn_state_dict_from_flax(variables)


def dynamic_vehicle_state_dict_from_flax(variables: Mapping
                                         ) -> Dict[str, torch.Tensor]:
    """Flax variables of the JAX DynamicVehicleClassifier
    (`VGG16Features_0/...`, `fc1`, `fc2`) -> a state dict for
    models.classifiers.DynamicVehicleClassifier."""
    return dsgn_state_dict_from_flax(variables)
