"""Read published PyTorch checkpoints: the DSGN `.tar` into the port's
compat assembly, the Stereo R-CNN `.pth` into the port's StereoRCNN, and
torchvision ResNet / VGG-16 state dicts into the classifiers' backbones.

Counterpart of eval_driving_safety_tpu/utils/torch_import.py.

DSGN. The upstream checkpoint is a PyTorch `.tar` saved from an
`nn.DataParallel` model: `{"state_dict": {"module.<key>": tensor}}`.
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

Stereo R-CNN and torchvision. The upstream names are mapped onto the JAX
model's Flax tree exactly as the JAX importer does (torch OIHW -> HWIO
kernels, (out, in) -> (in, out) dense kernels, BatchNorm -> FrozenBatchNorm
scale / bias / mean / var), and that tree goes through utils.from_flax
into the port's layout. A read recorder lists the keys no converter read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from eval_driving_safety_tpu_torch.config import DSGNConfig, StereoRCNNConfig
from eval_driving_safety_tpu_torch.models.dsgn_compat import (
    ConvBn, ConvBnReLU, DSGNCompat, DSGNCompatArch)
from eval_driving_safety_tpu_torch.utils.from_flax import (
    dsgn_state_dict_from_flax, stereo_rcnn_state_dict_from_flax)

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


# ---------------------------------------------------------------------------
# Stereo R-CNN and torchvision: upstream names -> the Flax tree -> the port
# ---------------------------------------------------------------------------

def _numpy(sd) -> Dict[str, np.ndarray]:
    return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in sd.items()}


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def deconv_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kH, kW) -> the Flax ConvTranspose
    kernel (kH, kW, in, out), flipped in both spatial axes (torch's
    transposed conv flips its kernel, Flax's does not)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def conv_as_dense_kernel(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (O, C, kH, kW) applied at full kernel extent == a
    Dense over the NHWC flatten: kernel[(i * kW + j) * C + c, o]."""
    return np.transpose(w, (2, 3, 1, 0)).reshape(-1, w.shape[0])


def dense_kernel(w: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.transpose(w, (1, 0))


def bn_params(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"]}


def convert_bottleneck(sd, tprefix: str) -> Dict[str, Any]:
    """One torchvision bottleneck (`layerL.B.`) -> models.resnet.Bottleneck
    params."""
    blk: Dict[str, Any] = {}
    for ci in range(3):
        blk[f"Conv_{ci}"] = {
            "kernel": conv_kernel(sd[f"{tprefix}conv{ci + 1}.weight"])}
        blk[f"FrozenBatchNorm_{ci}"] = bn_params(sd, f"{tprefix}bn{ci + 1}")
    if f"{tprefix}downsample.0.weight" in sd:
        blk["downsample_conv"] = {
            "kernel": conv_kernel(sd[f"{tprefix}downsample.0.weight"])}
        blk["downsample_bn"] = bn_params(sd, f"{tprefix}downsample.1")
    return blk


def convert_torchvision_resnet(sd, block_counts=(3, 4, 23, 3),
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """torchvision resnet50/101 state dict (keys under `prefix`) -> a
    state dict of models.resnet.ResNet."""
    sd = _numpy(sd)
    tree: Dict[str, Any] = {
        "stem_conv": {"kernel": conv_kernel(sd[prefix + "conv1.weight"])},
        "stem_bn": bn_params(sd, prefix + "bn1"),
    }
    for stage, n_blocks in enumerate(block_counts):
        for b in range(n_blocks):
            tree[f"layer{stage + 1}_block{b}"] = convert_bottleneck(
                sd, f"{prefix}layer{stage + 1}.{b}.")
    return dsgn_state_dict_from_flax(tree)


VGG16_CONV_LAYERS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_NAMES = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
               "conv3_2", "conv3_3", "conv4_1", "conv4_2", "conv4_3",
               "conv5_1", "conv5_2", "conv5_3")


def convert_torchvision_vgg16(sd, prefix: str = "features."
                              ) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 `.features` -> a state dict of
    models.vgg.VGG16Features."""
    sd = _numpy(sd)
    return dsgn_state_dict_from_flax({
        name: {"kernel": conv_kernel(sd[f"{prefix}{layer}.weight"]),
               "bias": sd[f"{prefix}{layer}.bias"]}
        for layer, name in zip(VGG16_CONV_LAYERS, VGG16_NAMES)})


def convert_stereo_rcnn_checkpoint(sd, num_anchors: int = 3
                                   ) -> Dict[str, Any]:
    """The published Stereo R-CNN's backbone, FPN and RPN -> the Flax
    tree {"backbone", "fpn", "rpn"}. Upstream names: RCNN_layer0.{0,1} the
    stem conv and BN, RCNN_layer{1..4}.{b} the bottlenecks, RCNN_toplayer
    / RCNN_latlayer{1,2,3} / RCNN_smooth{1,2,3} the FPN, RCNN_rpn.RPN_Conv
    / RPN_cls_score / RPN_bbox_pred_left_right the RPN. The objectness
    channels go from upstream's class-major (bg x A, fg x A) order to the
    anchor-major (A, 2) order of the model."""
    backbone: Dict[str, Any] = {
        "stem_conv": {"kernel": conv_kernel(sd["RCNN_layer0.0.weight"])},
        "stem_bn": bn_params(sd, "RCNN_layer0.1"),
    }
    stage = 1
    while f"RCNN_layer{stage}.0.conv1.weight" in sd:
        b = 0
        while f"RCNN_layer{stage}.{b}.conv1.weight" in sd:
            backbone[f"layer{stage}_block{b}"] = convert_bottleneck(
                sd, f"RCNN_layer{stage}.{b}.")
            b += 1
        stage += 1

    def conv_wb(name):
        return {"kernel": conv_kernel(sd[f"{name}.weight"]),
                "bias": sd[f"{name}.bias"]}

    fpn = {ours: conv_wb(f"RCNN_{ours}")
           for ours in ("toplayer", "latlayer1", "latlayer2", "latlayer3",
                        "smooth1", "smooth2", "smooth3")}
    cls_k = conv_kernel(sd["RCNN_rpn.RPN_cls_score.weight"])
    cls_b = sd["RCNN_rpn.RPN_cls_score.bias"]
    # ours channel (anchor * 2 + class) <- upstream (class * A + anchor)
    perm = [k * num_anchors + a for a in range(num_anchors) for k in range(2)]
    rpn = {"rpn_conv": conv_wb("RCNN_rpn.RPN_Conv"),
           "rpn_cls": {"kernel": cls_k[..., perm], "bias": cls_b[perm]},
           "rpn_box": conv_wb("RCNN_rpn.RPN_bbox_pred_left_right")}
    return {"backbone": backbone, "fpn": fpn, "rpn": rpn}


def convert_stereo_rcnn_heads(sd) -> Dict[str, Any]:
    """The published per-roi heads -> {"rcnn", "kpts", "num_kpts_convs"}.
    RCNN_top = Sequential(Conv2d(2C, 1024, P, stride=P), ReLU,
    Conv2d(1024, 1024, 1), ReLU) acts at full kernel extent, so each conv
    is a Dense over the NHWC flatten; RCNN_cls_score / RCNN_bbox_pred /
    RCNN_dim_orien_pred are Linear; RCNN_kpts is 3x3 convs and a 2x2
    stride-2 ConvTranspose2d, each followed by a ReLU (the even indices
    hold the weights), and kpts_class a 1x1 conv. The number of keypoint
    convs is read off the state dict."""
    rcnn = {
        "fc1": {"kernel": conv_as_dense_kernel(sd["RCNN_top.0.weight"]),
                "bias": sd["RCNN_top.0.bias"]},
        "fc2": {"kernel": conv_as_dense_kernel(sd["RCNN_top.2.weight"]),
                "bias": sd["RCNN_top.2.bias"]},
    }
    for ours in ("cls_score", "bbox_pred", "dim_orien_pred"):
        rcnn[ours] = {"kernel": dense_kernel(sd[f"RCNN_{ours}.weight"]),
                      "bias": sd[f"RCNN_{ours}.bias"]}
    kpts: Dict[str, Any] = {}
    n_convs = idx = 0
    while f"RCNN_kpts.{idx}.weight" in sd:
        w, b = sd[f"RCNN_kpts.{idx}.weight"], sd[f"RCNN_kpts.{idx}.bias"]
        if w.shape[2] == 3:
            n_convs += 1
            kpts[f"kpts_conv{n_convs}"] = {"kernel": conv_kernel(w),
                                           "bias": b}
        else:
            kpts["kpts_deconv"] = {"kernel": deconv_kernel(w), "bias": b}
        idx += 2
    kpts["kpts_class"] = {"kernel": conv_kernel(sd["kpts_class.weight"]),
                          "bias": sd["kpts_class.bias"]}
    return {"rcnn": rcnn, "kpts": kpts, "num_kpts_convs": n_convs}


class _ReadRecorder(dict):
    """A dict that records the keys read with [] (not those tested with
    `in`): the unmapped-key account of `import_stereo_rcnn`."""

    def __init__(self, base):
        super().__init__(base)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def import_stereo_rcnn(sd) -> Dict[str, Any]:
    """A published Stereo R-CNN state dict (DataParallel-wrapped or not)
    -> {"params": the Flax tree {backbone, fpn, rpn, rcnn, kpts},
    "num_kpts_convs", "unmapped": [keys no converter read]};
    `unmapped == []` is the contract of a complete import."""
    sd = strip_module_prefix(_numpy(sd))
    rec = _ReadRecorder(sd)
    params = convert_stereo_rcnn_checkpoint(rec)
    heads = convert_stereo_rcnn_heads(rec)
    params["rcnn"], params["kpts"] = heads["rcnn"], heads["kpts"]
    unmapped = sorted(k for k in sd if k not in rec.read
                      and not any(t in k for t in _IGNORABLE))
    return {"params": params, "num_kpts_convs": heads["num_kpts_convs"],
            "unmapped": unmapped}


def graft_stereo_rcnn(model, imported: Dict[str, Any]):
    """Load a full import into `model`, a models.stereo_rcnn.StereoRCNN
    with the import's number of keypoint convs; every weight is replaced
    (the anchor table is not a weight)."""
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(
        imported["params"], model))
    return model


def load_stereo_rcnn_checkpoint(path: str, cfg: StereoRCNNConfig):
    """The published Stereo R-CNN `.pth` (or `.tar`) -> (StereoRCNN with
    its weights, at `cfg` with the file's keypoint conv count; the import
    record; the file's `uncert`, or None)."""
    import dataclasses

    from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
    sd, uncert = load_torch_state_dict(path)
    imported = import_stereo_rcnn(sd)
    cfg = dataclasses.replace(cfg, kpts_convs=imported["num_kpts_convs"])
    return graft_stereo_rcnn(StereoRCNN(cfg), imported), imported, uncert
