"""Read the published DSGN checkpoint into the port's compat assembly.

Counterpart of the DSGN half of eval_driving_safety_tpu/utils/
torch_import.py. The upstream checkpoint is a PyTorch `.tar` saved from
an `nn.DataParallel` model: `{"state_dict": {"module.<key>": tensor}}`.
models.dsgn_compat.DSGNCompat carries the upstream keys, so the import is
nearly the identity: strip the `module.` prefix, read the architecture
off the tensors' shapes, and take every key the module has. Two things
are not the identity:
* a convbn block may sit one `Sequential` level deeper or shallower than
  the compat module has it (`x.0.0.weight` for `x.0.weight`), as the
  JAX import tolerates; such keys are renamed;
* BatchNorm's `num_batches_tracked` counters are dropped.
Every other key the module does not take is reported in `unmapped`, so a
checkpoint of another layout is diagnosed rather than half read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.dsgn_compat import (
    ConvBn, ConvBnReLU, DSGNCompat, DSGNCompatArch)

# keys an import may leave unread: torch BatchNorm's bookkeeping
_IGNORABLE = ("num_batches_tracked",)


def load_torch_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor],
                                              Optional[torch.Tensor]]:
    """torch.load (tensors and plain containers only) -> ({key: f32
    tensor}, the `uncert` vector if present). Takes the state dict out of
    a `model` or `state_dict` wrapper."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    uncert = None
    if isinstance(raw, dict):
        if "uncert" in raw:
            uncert = raw["uncert"].detach().float()
        for key in ("model", "state_dict"):
            if isinstance(raw.get(key), dict):
                raw = raw[key]
                break
    return ({k: v.detach().float() for k, v in raw.items()
             if isinstance(v, torch.Tensor)}, uncert)


def strip_module_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Remove a DataParallel `module.` prefix if every key carries it."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _convbn_out(sd, prefix: str):
    """Output channels of the convbn at `prefix` (either nesting), or None
    if absent."""
    for key in (f"{prefix}.0.0.weight", f"{prefix}.0.weight"):
        if key in sd:
            return int(sd[key].shape[0])
    return None


def discover_dsgn_arch(sd: Dict[str, torch.Tensor]) -> DSGNCompatArch:
    """Every architecture knob that leaves a trace in a DSGN state dict
    (widths, block counts, SPP branch count, tower depth, classes); the
    shapeless ones (pool windows, strides, dilations, GroupNorm groups)
    keep the upstream defaults."""
    d = DSGNCompatArch()
    fe = "feature_extraction."
    layer_channels, layer_blocks = [], []
    li = 1
    while _convbn_out(sd, f"{fe}layer{li}.0.conv1") is not None:
        b = 0
        while _convbn_out(sd, f"{fe}layer{li}.{b}.conv1") is not None:
            b += 1
        layer_channels.append(_convbn_out(sd, f"{fe}layer{li}.0.conv1"))
        layer_blocks.append(b)
        li += 1
    n_branch = 0
    while _convbn_out(sd, f"{fe}branch{n_branch + 1}.1") is not None:
        n_branch += 1
    bev = _convbn_out(sd, "rpn3d_conv3")
    tower = 0
    while f"rpn3d.cls_tower.{3 * tower}.weight" in sd:
        tower += 1
    return dataclasses.replace(
        d,
        base_channels=_convbn_out(sd, f"{fe}firstconv.0"),
        layer_channels=tuple(layer_channels),
        layer_blocks=tuple(layer_blocks),
        layer_strides=d.layer_strides[:len(layer_blocks)],
        layer_dilations=d.layer_dilations[:len(layer_blocks)],
        spp_pools=d.spp_pools[:n_branch],
        spp_channels=_convbn_out(sd, f"{fe}branch1.1"),
        last_channels=_convbn_out(sd, f"{fe}lastconv.0"),
        feature_channels=int(sd[f"{fe}lastconv.2.weight"].shape[0]),
        cv_channels=_convbn_out(sd, "dres0.2"),
        hg_channels=_convbn_out(sd, "hg1.conv1"),
        gv_channels=_convbn_out(sd, "rpn3d_conv"),
        bev_channels=bev,
        tower_convs=tower,
        gn_groups=(32 if bev % 32 == 0 else 4 if bev % 4 == 0 else 1),
        num_classes=int(sd["rpn3d.cls_logits.weight"].shape[0]),
    )


def _renested_prefixes(model: DSGNCompat) -> Dict[str, str]:
    """{prefix of a convbn's keys one Sequential level off the module's
    nesting: the module's prefix}."""
    out, wrapped = {}, set()
    for name, m in model.named_modules():          # parents first
        if isinstance(m, ConvBnReLU):              # ours x.0.{0,1}: x.{0,1}
            out[f"{name}."] = f"{name}.0."
            wrapped.add(f"{name}.0")
        elif isinstance(m, ConvBn) and name not in wrapped:
            out[f"{name}.0."] = f"{name}."         # ours x.{0,1}: x.0.{0,1}
    return out


def import_dsgn(sd: Dict[str, torch.Tensor]) -> Dict:
    """A DSGN state dict (DataParallel-wrapped or not) -> {"state_dict":
    keys of DSGNCompat(cfg, arch), "arch": the discovered
    DSGNCompatArch, "unmapped": [keys not taken]}; `unmapped == []` is
    the contract of a complete import."""
    sd = strip_module_prefix(sd)
    arch = discover_dsgn_arch(sd)
    with torch.device("meta"):
        model = DSGNCompat(DSGNConfig(), arch)
    want = set(model.state_dict())
    renest = _renested_prefixes(model)
    out, unmapped = {}, []
    for k, v in sd.items():
        key = k
        if key not in want:
            for theirs, ours in renest.items():
                if k.startswith(theirs) and ours + k[len(theirs):] in want:
                    key = ours + k[len(theirs):]
                    break
        if key in want:
            out[key] = v
        elif not any(t in k for t in _IGNORABLE):
            unmapped.append(k)
    return {"state_dict": out, "arch": arch, "unmapped": sorted(unmapped)}


def load_dsgn_checkpoint(path: str, cfg: DSGNConfig):
    """Published DSGN `.tar` (or `.pth`) -> (DSGNCompat with its weights,
    the import record). The architecture comes from the state dict, the
    geometry from `cfg`; the BEV conv's input width must equal
    cfg.num_voxels_y x the voxel channels."""
    sd, _ = load_torch_state_dict(path)
    imported = import_dsgn(sd)
    arch = imported["arch"]
    bev_in = imported["state_dict"]["rpn3d_conv3.0.weight"].shape[1]
    expect = cfg.num_voxels_y * arch.gv_channels
    if bev_in != expect:
        raise ValueError(
            f"checkpoint BEV input dim {bev_in} != num_voxels_y * "
            f"gv_channels = {expect}; adjust DSGNConfig.num_voxels_y to "
            f"{bev_in // arch.gv_channels}")
    model = DSGNCompat(cfg, arch)
    model.load_state_dict(imported["state_dict"])
    return model, imported
