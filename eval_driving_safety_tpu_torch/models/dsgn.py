"""DSGN (Deep Stereo Geometry Network) in PyTorch.

Counterpart of eval_driving_safety_tpu/models/dsgn.py, with the same
outputs (`depth_preds`, `bbox_cls`, `bbox_reg`, `bbox_centerness`), the
same channel-last layouts and the same parameter names: stereo features
-> plane-sweep volume (ops.psv_warp) -> hourglass of (2+1)D convs whose
stride-1 depth stages run the fused kernel (ops.depthconv) -> Score3D +
soft-argmin depth at three scales, and a 3D geometric volume -> BEV
detection head.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.common import (
    Conv, ConvBnRelu, FrozenBatchNorm, lecun_normal_, resize_bilinear,
    resize_trilinear, same_pads)
from eval_driving_safety_tpu_torch.ops.cost_volume import (
    depth_planes, psv_to_3dgv, soft_argmin_depth)
from eval_driving_safety_tpu_torch.ops.depthconv import depth_tap_conv
from eval_driving_safety_tpu_torch.ops.psv_warp import build_psv


def torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class StereoFeatureNet(nn.Module):
    """PSMNet-style siamese 2D feature extractor -> stride-4 features."""

    def __init__(self, channels: int = 32, dtype=torch.float32):
        super().__init__()
        c = channels
        specs = [(3, c, 3, 2, 1, True), (c, c, 3, 1, 1, True),
                 (c, c, 3, 2, 1, True)]
        cin = c
        for i, dil in enumerate((1, 1, 2, 4)):
            specs += [(cin, 2 * c, 3, 1, dil, True),
                      (2 * c, 2 * c, 3, 1, dil, False)]
            if i == 0:                          # 1x1 projection c -> 2c
                specs.append((c, 2 * c, 1, 1, 1, False))
            cin = 2 * c
        specs += [(2 * c, c, 1, 1, 1, True)] * 3              # SPP branches
        specs += [(5 * c, 2 * c, 3, 1, 1, True), (2 * c, c, 1, 1, 1, False)]
        for i, (ci, co, k, s, dil, relu) in enumerate(specs):
            self.add_module(f"ConvBnRelu_{i}", ConvBnRelu(
                ci, co, k, s, dil, relu, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = lambda i: getattr(self, f"ConvBnRelu_{i}")
        x = layer(2)(layer(1)(layer(0)(x)))
        i = 3
        for blk in range(4):
            y = layer(i + 1)(layer(i)(x))
            i += 2
            if blk == 0:
                x = layer(i)(x)
                i += 1
            x = torch.relu(x + y)
        h, w = x.shape[1], x.shape[2]
        branches = [x]
        for pool in (8, 16, 32):
            p = resize_bilinear(x, max(h // pool, 1), max(w // pool, 1))
            branches.append(resize_bilinear(layer(i)(p), h, w))
            i += 1
        x = layer(i)(torch.cat(branches, dim=-1))
        return layer(i + 1)(x)


class DepthKernel(nn.Module):
    """Holder of the (3, C, F) depth-conv kernel, the layout of Flax's
    `nn.Conv(F, (3,))` that the fused kernel takes as it is."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, cin, features))


class ConvBnRelu2p1D(nn.Module):
    """Factorized (2+1)D conv: 3x3 over (H, W) with D folded into the
    batch ("SAME" padding), then 3 taps over D, frozen BN and ReLU.

    Stride-1 blocks run the depth stage as the fused kernel; stride-2
    blocks run it as a library conv over D, as the JAX model does."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 relu: bool = True, dtype=torch.float32):
        super().__init__()
        self.spatial = Conv(cin, features, 3, stride, padding="SAME",
                            dtype=dtype)
        self.depth = DepthKernel(features, features)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.stride, self.relu, self.dtype = stride, relu, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:    # (B, D, H, W, C)
        b, d, h, w, c = x.shape
        y = self.spatial(x.reshape(b * d, h, w, c))
        h2, w2, f = y.shape[1], y.shape[2], y.shape[3]
        y = y.reshape(b, d, h2, w2, f)
        if self.stride == 1:
            inv, off = self.FrozenBatchNorm_0.folded()
            return depth_tap_conv(y, self.depth.weight, inv.to(self.dtype),
                                  off.to(self.dtype), relu=self.relu)
        lo, hi = same_pads(d, 3, self.stride)
        kern = self.depth.weight.to(self.dtype).permute(2, 1, 0)
        z = F.conv3d(F.pad(y.permute(0, 4, 1, 2, 3), (0, 0, 0, 0, lo, hi)),
                     kern[..., None, None], stride=(self.stride, 1, 1))
        z = self.FrozenBatchNorm_0(z.permute(0, 2, 3, 4, 1))
        return torch.relu(z) if self.relu else z


class Score3D(nn.Module):
    """1-output-channel 3x3x3 matching-score conv with bias: (B, D, H, W, C)
    -> (B, D, H, W). The JAX model's "tap27" form computes the same
    function; here it is one library conv."""

    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, cin, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                     self.weight.to(self.dtype), self.bias.to(self.dtype),
                     padding=1)
        return y[:, 0]


class Hourglass3D(nn.Module):
    """(2+1)D conv hourglass over the (D, H, W) cost volume; returns the
    half-volume encoder/decoder tensors and the full-volume output."""

    def __init__(self, cin: int, channels: int, dtype=torch.float32):
        super().__init__()
        c = channels
        specs = [(cin, c, 1), (c, 2 * c, 2), (2 * c, 2 * c, 1),
                 (2 * c, 2 * c, 2), (2 * c, 2 * c, 1), (2 * c, 2 * c, 1),
                 (2 * c, c, 1)]
        for i, (ci, co, s) in enumerate(specs):
            self.add_module(f"ConvBnRelu2p1D_{i}", ConvBnRelu2p1D(
                ci, co, s, dtype=dtype))

    def forward(self, x):
        layer = lambda i: getattr(self, f"ConvBnRelu2p1D_{i}")
        x0 = layer(0)(x)
        d1 = layer(2)(layer(1)(x0))
        d2 = layer(4)(layer(3)(d1))
        u1 = layer(5)(resize_trilinear(d2, d1.shape[1:4])) + d1
        u0 = layer(6)(resize_trilinear(u1, x0.shape[1:4])) + x0
        return d1, u1, u0


class BEVHead(nn.Module):
    """FCOS-style BEV head: cls / reg(8) / centerness on (B, Z, X, C)."""

    def __init__(self, cin: int, num_classes: int, channels: int = 64,
                 dtype=torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"ConvBnRelu_{i}", ConvBnRelu(
                cin if i == 0 else channels, channels, 3, 1, dtype=dtype))
        self.cls = Conv(channels, num_classes, 3, bias=True, dtype=dtype)
        self.reg = Conv(channels, 8, 3, bias=True, dtype=dtype)
        self.centerness = Conv(channels, 1, 3, bias=True, dtype=dtype)

    def forward(self, bev):
        t = self.ConvBnRelu_1(self.ConvBnRelu_0(bev))
        cls_t, reg_t = self.ConvBnRelu_2(t), self.ConvBnRelu_3(t)
        return self.cls(cls_t), self.reg(reg_t), self.centerness(cls_t)[..., 0]


class DSGN(nn.Module):
    """Stereo pair + calibration -> depth maps + BEV detections.

    Inputs: im_left/im_right (B, H, W, 3) normalized RGB, calib_fu,
    calib_baseline, calib_cu, calib_cv (B,) float32."""

    def __init__(self, cfg: DSGNConfig):
        super().__init__()
        if (cfg.psv_method, cfg.depthconv_method) != ("kernel", "kernel"):
            raise ValueError(
                f"psv_method {cfg.psv_method!r}, depthconv_method "
                f"{cfg.depthconv_method!r}: the port runs the kernels "
                f"(\"kernel\"); their plain versions serve CPU tensors")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        fc, pc, gc = cfg.feature_channels, cfg.psv_channels, cfg.gv_channels
        self.StereoFeatureNet_0 = StereoFeatureNet(fc, dtype=dt)
        self.Hourglass3D_0 = Hourglass3D(2 * fc, pc, dtype=dt)
        scale_channels = (2 * pc, 2 * pc, pc)[-cfg.num_depth_preds:]
        for i, ch in enumerate(scale_channels):
            self.add_module(f"depth_score{i}", Score3D(ch, dtype=dt))
        if cfg.rpn3d_enable:
            for i in range(3):
                self.add_module(f"ConvBnRelu2p1D_{i}", ConvBnRelu2p1D(
                    pc if i == 0 else gc, gc, dtype=dt))
            self.BEVHead_0 = BEVHead(cfg.num_voxels_y * gc, cfg.num_classes,
                                     cfg.head_channels, dtype=dt)

    def init_weights(self, seed: int = 0) -> "DSGN":
        """Fresh init with Flax's distributions: lecun-normal kernels,
        zero biases (cls -4.59), BN scale 1, mean 0, var 1."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":
                # fan_in of the Flax layout: all but the output axis
                fan_in = (p.shape[0] * p.shape[1] if p.dim() == 3
                          else p[0].numel())
                lecun_normal_(p, fan_in, g)
        with torch.no_grad():
            if self.cfg.rpn3d_enable:
                self.BEVHead_0.cls.bias.fill_(-4.59)
        return self

    def forward(self, im_left, im_right, calib_fu, calib_baseline,
                calib_cu, calib_cv) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        stride = cfg.feature_stride
        planes = depth_planes(cfg.min_depth, cfg.max_depth,
                              cfg.num_depth_planes, device=im_left.device)
        fl = self.StereoFeatureNet_0(im_left.to(dt))
        fr = self.StereoFeatureNet_0(im_right.to(dt))
        psv = build_psv(fl, fr, calib_fu.to(dt), calib_baseline.to(dt),
                        planes.to(dt), stride)                 # (B,D,H,W,2C)

        if cfg.remat:
            s0, s1, s2 = checkpoint(self.Hourglass3D_0, psv,
                                    use_reentrant=False)
        else:
            s0, s1, s2 = self.Hourglass3D_0(psv)

        full_h, full_w = im_left.shape[1], im_left.shape[2]
        depth_preds = []
        scales = (s0, s1, s2)[-cfg.num_depth_preds:]
        for i, s in enumerate(scales):
            score = getattr(self, f"depth_score{i}")(s)
            if score.shape[1] != cfg.num_depth_planes:
                score = resize_trilinear(
                    score[..., None], (cfg.num_depth_planes, psv.shape[2],
                                       psv.shape[3]))[..., 0]
            depth = soft_argmin_depth(score.float(), planes)
            depth_preds.append(
                resize_bilinear(depth[..., None], full_h, full_w)[..., 0])
        out = {"depth_preds": depth_preds}

        if cfg.rpn3d_enable:
            gv_in = self.ConvBnRelu2p1D_0(s2)
            voxels = psv_to_3dgv(gv_in, planes, calib_fu, calib_cu,
                                 calib_cv, cfg, stride)        # (B,Z,Y,X,C)
            voxels = self.ConvBnRelu2p1D_2(
                self.ConvBnRelu2p1D_1(voxels.to(dt)))
            b, z, y, x, c = voxels.shape
            bev = voxels.permute(0, 1, 3, 2, 4).reshape(b, z, x, y * c)
            cls, reg, ctr = self.BEVHead_0(bev)
            out.update(bbox_cls=cls.float(), bbox_reg=reg.float(),
                       bbox_centerness=ctr.float())
        return out
