"""DSGN checkpoint-compat assembly: the upstream layer topology, whose
`state_dict()` keys are the upstream checkpoint's.

Counterpart of eval_driving_safety_tpu/models/dsgn_compat.py. The fast
model (models/dsgn.py) factorizes its hourglass into (2+1)D convs and
cannot take the published DSGN weights; this module mirrors the upstream
module graph, so the published `.tar`, once its DataParallel `module.`
prefix is stripped (utils.torch_import), loads with `load_state_dict`:

* `feature_extraction`: PSMNet's extractor, `firstconv` (3 convbn, the
  first of stride 2), `layer1..4` (BasicBlock stacks, no final ReLU),
  SPP `branch1..N` (average pool, 1x1 convbn, bilinear upsample) and
  `lastconv`, to stride-4 features;
* `dres0`, `dres1` (with its residual), `hg1` (one full-3D hourglass
  with PSMNet's pre and post skips) and `classif1` on the plane-sweep
  volume;
* `rpn3d_conv` into the 3D geometric volume, `rpn3d_conv2` on its
  voxels, `rpn3d_conv3` on the Y-collapsed BEV plane, and the FCOS
  towers and heads of `rpn3d`.

The plane-sweep volume is built by ops.psv_warp (K1, K2 on the card); the
3D convs are library convs (cuDNN on the card), as the JAX package's are
plain `lax.conv` outside any Pallas kernel. Tensors are channel-last, as
in the rest of the port: a conv sees its input as a `channels_last` view.
Outputs use the fast model's keys (`depth_preds`, `bbox_cls`,
`bbox_reg`, `bbox_centerness`), so the attack, predict and patch CLIs
drive either model.

On the model axis (`volume_constraint`, as models/dsgn.py) each rank
builds and convolves its depth planes; the 3D convs take halos that
follow PyTorch's padding: a stride-1 conv one plane on each side, a
stride-2 conv (padding 1) one plane below, the transposed conv (k 3, s 2,
p 1, output padding 1) one plane above. The score, the soft-argmin and
the 3D geometric volume are as in the fast model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.common import (
    Conv, lecun_normal_, resize_bilinear)
from eval_driving_safety_tpu_torch.models.dsgn import Score3D, torch_dtype
from eval_driving_safety_tpu_torch.ops.cost_volume import (
    depth_planes, psv_to_3dgv, soft_argmin_depth)
from eval_driving_safety_tpu_torch.ops.psv_warp import build_psv
from eval_driving_safety_tpu_torch.parallel.volume import (
    enter_volume, gather_planes, halo_exchange)


@dataclass(frozen=True)
class DSGNCompatArch:
    """Architecture of the upstream assembly. Every field that leaves a
    trace in the state dict (widths, counts) is read from it by
    `utils.torch_import.discover_dsgn_arch`; the others (pool windows,
    strides, dilations, GroupNorm groups) are the upstream constants."""
    base_channels: int = 32                       # firstconv/layer1 width
    layer_channels: Tuple[int, ...] = (32, 64, 128, 128)
    layer_blocks: Tuple[int, ...] = (3, 16, 3, 3)
    layer_strides: Tuple[int, ...] = (1, 2, 1, 1)
    layer_dilations: Tuple[int, ...] = (1, 1, 1, 2)
    spp_pools: Tuple[int, ...] = (64, 32, 16, 8)  # branch1..branchN windows
    spp_channels: int = 32
    last_channels: int = 128                      # lastconv 3x3 width
    feature_channels: int = 32                    # lastconv 1x1 output
    cv_channels: int = 32                         # dres0/dres1 width
    hg_channels: int = 64                         # hourglass inner width
    gv_channels: int = 64                         # rpn3d_conv/conv2 width
    bev_channels: int = 128                       # rpn3d_conv3 + towers
    tower_convs: int = 2
    gn_groups: int = 32
    num_classes: int = 1

    @staticmethod
    def tiny() -> "DSGNCompatArch":
        return DSGNCompatArch(
            base_channels=8, layer_channels=(8, 16, 24, 24),
            layer_blocks=(1, 2, 1, 1), spp_pools=(8, 4),
            spp_channels=8, last_channels=16, feature_channels=8,
            cv_channels=8, hg_channels=16, gv_channels=8,
            bev_channels=16, tower_convs=1, gn_groups=4)


class BatchNorm(nn.Module):
    """Inference BatchNorm on channel-last input under torch BatchNorm's
    names: y = (x - running_mean) / sqrt(running_var + eps) * weight +
    bias, folded in f32 and applied in x's dtype, as the port's
    FrozenBatchNorm and the JAX package's do."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.reciprocal(
            torch.sqrt(self.running_var + self.eps))
        off = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype) + off.to(x.dtype)


class Conv3d(nn.Module):
    """3x3x3 conv, padding 1, no bias, on (B, D, H, W, C); weight in
    nn.Conv3d's (O, I, 3, 3, 3) layout. With `shard` the input is a model
    rank's planes: a halo of one plane on each side (stride 1) or below
    them (stride 2: output plane j reads planes 2j-1..2j+1), no D
    padding."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))
        self.stride, self.dtype = stride, dtype

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        pad = 1
        if shard is not None:
            x, pad = halo_exchange(x, shard, 1, 2 - self.stride), (0, 1, 1)
        y = F.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                     self.weight.to(self.dtype), None, self.stride, pad)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class ConvTranspose3d(nn.Module):
    """nn.ConvTranspose3d(k=3, stride=2, padding=1, output_padding=1), no
    bias, on (B, D, H, W, C): every side doubles. The weight is the
    upstream (I, O, 3, 3, 3) tensor as it is."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3, 3))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is None:
            y = F.conv_transpose3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                                   self.weight.to(self.dtype), stride=2,
                                   padding=1, output_padding=1)
            return y.permute(0, 2, 3, 4, 1).contiguous()
        # a model rank's planes: output planes 2i and 2i+1 read input
        # planes i and i+1, the last of a rank's from the next rank
        d = x.shape[1]
        y = F.conv_transpose3d(
            halo_exchange(x, shard, 0, 1).to(self.dtype).permute(
                0, 4, 1, 2, 3), self.weight.to(self.dtype), stride=2,
            padding=1, output_padding=(0, 1, 1))
        return y[:, :, :2 * d].permute(0, 2, 3, 4, 1).contiguous()


class GroupNorm(nn.GroupNorm):
    """GroupNorm on (B, H, W, C), computed in f32 and returned in x's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class AvgPool(nn.Module):
    """Non-overlapping average pool on (B, H, W, C), the window clamped to
    the input (min(pool, H), min(pool, W)), a ragged edge dropped:
    AvgPool2d(pool, stride=pool) as a reshape and a mean in f32, whose
    backward is deterministic on the card."""

    def __init__(self, pool: int):
        super().__init__()
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ph, pw = min(self.pool, h), min(self.pool, w)
        oh, ow = h // ph, w // pw
        y = x[:, :oh * ph, :ow * pw].float().reshape(b, oh, ph, ow, pw, c)
        return y.mean((2, 4)).to(x.dtype)


def run_planes(module: nn.Module, x: torch.Tensor, shard) -> torch.Tensor:
    """`module(x)`, with `shard` passed on to the 3D convs and the score
    inside it (through Sequentials); the other layers act per plane."""
    if shard is None:
        return module(x)
    if isinstance(module, (Conv3d, ConvTranspose3d, Score3D)):
        return module(x, shard)
    if isinstance(module, nn.Sequential):
        for m in module:
            x = run_planes(m, x, shard)
        return x
    return module(x)


class ConvBn(nn.Sequential):
    """Upstream `convbn` / `convbn_3d`: Sequential(conv, BatchNorm)."""

    def __init__(self, conv: nn.Module, features: int):
        super().__init__(conv, BatchNorm(features))


class ConvBnReLU(nn.Sequential):
    """Upstream Sequential(convbn, ReLU): its keys nest one level deeper
    (`x.0.0.weight`)."""

    def __init__(self, convbn: ConvBn):
        super().__init__(convbn, nn.ReLU())


def convbn2d(cin, cout, kernel=3, stride=1, dilation=1, dtype=torch.float32):
    return ConvBn(Conv(cin, cout, kernel, stride, dilation, dtype=dtype),
                  cout)


def convbn3d(cin, cout, stride=1, dtype=torch.float32):
    return ConvBn(Conv3d(cin, cout, stride, dtype=dtype), cout)


class BasicBlock(nn.Module):
    """PSMNet BasicBlock: convbn + ReLU, convbn, residual add, no final
    ReLU."""

    def __init__(self, cin, cout, stride, dilation, dtype):
        super().__init__()
        self.conv1 = ConvBnReLU(convbn2d(cin, cout, 3, stride, dilation,
                                         dtype))
        self.conv2 = convbn2d(cout, cout, 3, 1, dilation, dtype)
        self.downsample = convbn2d(cin, cout, 1, stride, dtype=dtype) \
            if stride != 1 or cin != cout else None

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return y + x


class FeatureExtraction(nn.Module):
    """PSMNet `feature_extraction`: stem, residual stacks, SPP, lastconv;
    the concat order is layer2, layer4, branchN..branch1."""

    def __init__(self, a: DSGNCompatArch, dtype=torch.float32):
        super().__init__()
        c = a.base_channels
        self.firstconv = nn.Sequential(
            convbn2d(3, c, 3, 2, dtype=dtype), nn.ReLU(),
            convbn2d(c, c, dtype=dtype), nn.ReLU(),
            convbn2d(c, c, dtype=dtype), nn.ReLU())
        cin = c
        for li, (ch, n, st, dil) in enumerate(zip(
                a.layer_channels, a.layer_blocks, a.layer_strides,
                a.layer_dilations), start=1):
            setattr(self, f"layer{li}", nn.Sequential(*(
                BasicBlock(cin if b == 0 else ch, ch, st if b == 0 else 1,
                           dil, dtype) for b in range(n))))
            cin = ch
        for bi, pool in enumerate(a.spp_pools, start=1):
            setattr(self, f"branch{bi}", nn.Sequential(
                AvgPool(pool), convbn2d(cin, a.spp_channels, 1, dtype=dtype),
                nn.ReLU()))
        cat = a.layer_channels[1] + cin + len(a.spp_pools) * a.spp_channels
        self.lastconv = nn.Sequential(
            convbn2d(cat, a.last_channels, dtype=dtype), nn.ReLU(),
            Conv(a.last_channels, a.feature_channels, 1, bias=True,
                 dtype=dtype))
        self.num_layers, self.num_branches = len(a.layer_blocks), \
            len(a.spp_pools)

    def forward(self, x):
        x = self.firstconv(x)
        outs = []
        for li in range(1, self.num_layers + 1):
            x = getattr(self, f"layer{li}")(x)
            outs.append(x)
        raw, skip = outs[1], outs[-1]
        h, w = skip.shape[1], skip.shape[2]
        branches = [resize_bilinear(getattr(self, f"branch{bi}")(skip), h, w)
                    for bi in range(self.num_branches, 0, -1)]
        return self.lastconv(torch.cat([raw, skip, *branches], dim=-1))


class Hourglass(nn.Module):
    """PSMNet hourglass: two stride-2 3D convbn down, two transposed convs
    up, skip adds at both scales, output not ReLU'd. (D, H, W) must be
    divisible by 4."""

    def __init__(self, cin: int, c: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBnReLU(convbn3d(cin, c, 2, dtype))
        self.conv2 = convbn3d(c, c, dtype=dtype)
        self.conv3 = ConvBnReLU(convbn3d(c, c, 2, dtype))
        self.conv4 = ConvBnReLU(convbn3d(c, c, dtype=dtype))
        self.conv5 = ConvBn(ConvTranspose3d(c, c, dtype), c)
        self.conv6 = ConvBn(ConvTranspose3d(c, cin, dtype), cin)

    def forward(self, x, shard=None):
        run = lambda m, t: run_planes(m, t, shard)
        pre = torch.relu(run(self.conv2, run(self.conv1, x)))
        out2 = run(self.conv4, run(self.conv3, pre))
        post = torch.relu(run(self.conv5, out2) + pre)
        return run(self.conv6, post)


class BEVHead(nn.Module):
    """FCOS-style BEV head: conv + GroupNorm + ReLU towers, then
    `cls_logits`, `bbox_pred` and `centerness`."""

    def __init__(self, a: DSGNCompatArch, dtype=torch.float32):
        super().__init__()
        c = a.bev_channels

        def tower():
            layers = []
            for _ in range(a.tower_convs):
                layers += [Conv(c, c, 3, bias=True, dtype=dtype),
                           GroupNorm(a.gn_groups, c, eps=1e-5), nn.ReLU()]
            return nn.Sequential(*layers)
        self.cls_tower = tower()
        self.bbox_tower = tower()
        self.cls_logits = Conv(c, a.num_classes, 3, bias=True, dtype=dtype)
        self.bbox_pred = Conv(c, 8, 3, bias=True, dtype=dtype)
        self.centerness = Conv(c, 1, 3, bias=True, dtype=dtype)

    def forward(self, bev):
        ct, bt = self.cls_tower(bev), self.bbox_tower(bev)
        return (self.cls_logits(ct), self.bbox_pred(bt),
                self.centerness(bt)[..., 0])


def bev_collapse(voxels: torch.Tensor) -> torch.Tensor:
    """(B, Z, Y, X, C) -> (B, Z, X, C*Y), channel index c * Y + y (c
    outer): the order upstream's contiguous `view(N, C*Y, Z, X)` of an
    (N, C, Y, Z, X) volume gives, which the imported rpn3d_conv3 weights
    expect. The other order would permute every BEV input silently."""
    b, z, y, x, c = voxels.shape
    return voxels.permute(0, 1, 3, 4, 2).reshape(b, z, x, c * y)


class DSGNCompat(nn.Module):
    """Upstream-topology DSGN, with the fast model's call signature and
    output keys; `cfg` gives the geometry (input size, planes, voxel
    grid, dtype), `arch` the layer widths; `volume_constraint` as
    models.dsgn.DSGN's."""

    def __init__(self, cfg: DSGNConfig,
                 arch: DSGNCompatArch = DSGNCompatArch(),
                 volume_constraint=None):
        super().__init__()
        self.cfg, self.arch = cfg, arch
        self.volume_constraint = volume_constraint
        dt = torch_dtype(cfg.dtype)
        a = arch
        cv = a.cv_channels
        self.feature_extraction = FeatureExtraction(a, dt)
        self.dres0 = nn.Sequential(
            convbn3d(2 * a.feature_channels, cv, dtype=dt), nn.ReLU(),
            convbn3d(cv, cv, dtype=dt), nn.ReLU())
        self.dres1 = nn.Sequential(convbn3d(cv, cv, dtype=dt), nn.ReLU(),
                                   convbn3d(cv, cv, dtype=dt))
        self.hg1 = Hourglass(cv, a.hg_channels, dt)
        self.classif1 = nn.Sequential(convbn3d(cv, cv, dtype=dt), nn.ReLU(),
                                      Score3D(cv, dtype=dt, bias=False))
        if cfg.rpn3d_enable:
            self.rpn3d_conv = convbn3d(cv, a.gv_channels, dtype=dt)
            self.rpn3d_conv2 = convbn3d(a.gv_channels, a.gv_channels,
                                        dtype=dt)
            self.rpn3d_conv3 = convbn2d(cfg.num_voxels_y * a.gv_channels,
                                        a.bev_channels, dtype=dt)
            self.rpn3d = BEVHead(a, dt)

    def init_weights(self, seed: int = 0) -> "DSGNCompat":
        """Fresh weights with Flax's distributions: lecun-normal conv
        weights, zero biases (cls_logits -4.59), BatchNorm and GroupNorm
        at identity."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, ConvTranspose3d):
                lecun_normal_(m.weight, m.weight[:, 0].numel(), g)
            elif isinstance(m, (Conv, Conv3d, Score3D)):
                lecun_normal_(m.weight, m.weight[0].numel(), g)
        if self.cfg.rpn3d_enable:
            with torch.no_grad():
                self.rpn3d.cls_logits.bias.fill_(-4.59)
        return self

    def forward(self, im_left, im_right, calib_fu, calib_baseline,
                calib_cu, calib_cv) -> Dict[str, torch.Tensor]:
        cfg, shard = self.cfg, self.volume_constraint
        dt = torch_dtype(cfg.dtype)
        stride = cfg.feature_stride
        planes = depth_planes(cfg.min_depth, cfg.max_depth,
                              cfg.num_depth_planes, device=im_left.device)
        fl = self.feature_extraction(im_left.to(dt))
        fr = self.feature_extraction(im_right.to(dt))
        fl, fr, mine = enter_volume(self, shard, fl, fr, planes)
        psv = build_psv(fl, fr, calib_fu.to(dt), calib_baseline.to(dt),
                        mine.to(dt), stride)                   # (B,D,H,W,2C)
        run = lambda m, t: run_planes(m, t, shard)
        x = run(self.dres0, psv)
        x = run(self.dres1, x) + x
        hg = (checkpoint(self.hg1, x, shard, use_reentrant=False)
              if cfg.remat else self.hg1(x, shard)) + x
        score = run(self.classif1, hg)                         # (B,D,H,W)
        if shard is not None:
            score = gather_planes(score, shard)
        depth = soft_argmin_depth(score.float(), planes)
        depth = resize_bilinear(depth[..., None], im_left.shape[1],
                                im_left.shape[2])[..., 0]
        out = {"depth_preds": [depth]}
        if cfg.rpn3d_enable:
            gv = torch.relu(run(self.rpn3d_conv, hg))
            voxels = psv_to_3dgv(gv, planes, calib_fu, calib_cu, calib_cv,
                                 cfg, stride, shard)           # (B,Z,Y,X,C)
            voxels = torch.relu(self.rpn3d_conv2(voxels.to(dt)))
            bev = torch.relu(self.rpn3d_conv3(bev_collapse(voxels)))
            cls, reg, ctr = self.rpn3d(bev)
            out.update(bbox_cls=cls.float(), bbox_reg=reg.float(),
                       bbox_centerness=ctr.float())
        return out
