"""Plain float32 DSGN with its attack loss.

A frozen copy of the port's DSGN (`models/dsgn.py`, `models/common.py`,
`ops/cost_volume.py`, `models/rpn3d_loss.py`) at the same parameter
names, with the plane-sweep warp and the depth-tap conv as the plain
PyTorch arithmetic that the port keeps for CPU tensors; no model axis,
no remat. Every conv and matmul operand passes through `cast`
(reference.precision): identity for the reference, float8 for the
control. Channel-last layouts as in the port: images (B, H, W, 3),
volumes (B, D, H, W, C), voxels (B, Z, Y, X, C).
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import exact


def config(sizes: dict) -> SimpleNamespace:
    """The model's sizes from a configuration file's `model` group."""
    cfg = SimpleNamespace(**sizes)
    cfg.input = SimpleNamespace(**sizes["input"])
    return cfg


def same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, dilation=1,
                 padding="sym", bias=False, cast=exact):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.padding, self.cast = padding, cast

    def forward(self, x):
        x = self.cast(x.permute(0, 3, 1, 2))
        if self.padding == "SAME":
            (t, b), (l, r) = (same_pads(x.shape[2], self.kernel, self.stride),
                              same_pads(x.shape[3], self.kernel, self.stride))
        else:
            t = b = l = r = self.dilation * (self.kernel // 2)
        x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.cast(self.weight), self.bias, self.stride, 0,
                     self.dilation)
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))
        self.eps = eps

    def folded(self):
        inv = self.scale / torch.sqrt(self.var + self.eps)
        return inv, self.bias - self.mean * inv

    def forward(self, x):
        inv, off = self.folded()
        return x * inv + off


class ConvBnRelu(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, dilation=1,
                 relu=True, cast=exact):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, dilation, cast=cast)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.relu = relu

    def forward(self, x):
        x = self.FrozenBatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.relu else x


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """(n_out, n_in) weights of a half-pixel linear resize, antialiased
    when it shrinks (jax.image.resize's "linear")."""
    with torch.inference_mode(False):
        eye = torch.eye(n_in).reshape(n_in, 1, 1, n_in)
        cols = F.interpolate(eye, size=(1, n_out), mode="bilinear",
                             align_corners=False, antialias=n_out < n_in)
        return cols[:, 0, 0, :].t().contiguous().to(device)


def _resize_axis(x, axis, n_out):
    if x.shape[axis] == n_out:
        return x
    m = resize_matrix(x.shape[axis], n_out, str(x.device))
    return torch.movedim(torch.movedim(x, axis, -1) @ m.t(), -1, axis)


def resize_bilinear(x, out_h, out_w):
    return _resize_axis(_resize_axis(x, 1, out_h), 2, out_w)


def resize_trilinear(x, size):
    for axis, n in zip((1, 2, 3), size):
        x = _resize_axis(x, axis, n)
    return x


def depth_planes(cfg, device):
    return torch.linspace(cfg.min_depth, cfg.max_depth, cfg.num_depth_planes,
                          dtype=torch.float32, device=device)


def shift_along_width(feat, disps):
    """feat (B, H, W, C) sampled at x - disp for each (B, D) disparity,
    zero where x - disp leaves [0, W-1] -> (B, D, H, W, C)."""
    b, h, w, c = feat.shape
    k = torch.clamp(torch.floor(disps), 0.0, w - 1.0)
    f = (disps - k)[:, :, None, None, None]
    xs = torch.arange(w, device=feat.device)
    xa = xs - k.long()[..., None]
    ft = feat.permute(0, 2, 1, 3)
    bi = torch.arange(b, device=feat.device)[:, None, None]

    def tap(idx):
        v = ft[bi, idx.clamp(0, w - 1)].permute(0, 1, 3, 2, 4)
        return v * ((idx >= 0) & (idx < w))[:, :, None, :, None]

    out = (1.0 - f) * tap(xa) + f * tap(xa - 1)
    xm = xs.float()[None, None, :] - disps[..., None]
    valid = (xm >= 0.0) & (xm <= w - 1.0)
    return out * valid[:, :, None, :, None]


def build_psv(fl, fr, f_u, baseline, planes, stride):
    disps = f_u[:, None] * baseline[:, None] / planes[None, :] / stride
    d = disps.shape[1]
    return torch.cat([fl[:, None].expand(-1, d, -1, -1, -1),
                      shift_along_width(fr, disps)], dim=-1)


def tent_weights(coords, src_len):
    src = torch.arange(src_len, dtype=coords.dtype, device=coords.device)
    w = torch.clamp_min(1.0 - torch.abs(src - coords[..., None]), 0.0)
    valid = ((coords >= 0.0) & (coords <= src_len - 1.0))[..., None]
    return w * valid


def psv_to_3dgv(vol, planes, f_u, c_u, c_v, cfg, stride, cast):
    d, dev = planes.shape[0], vol.device
    zs = np.linspace(cfg.voxel_z_min, cfg.voxel_z_max, cfg.num_voxels_z)
    ys = np.linspace(cfg.voxel_y_min, cfg.voxel_y_max, cfg.num_voxels_y)
    xs = np.linspace(cfg.voxel_x_min, cfg.voxel_x_max, cfg.num_voxels_x)
    dz = (float(cfg.max_depth) - float(cfg.min_depth)) / (d - 1)
    di = torch.as_tensor(((zs - float(cfg.min_depth)) / dz)
                         .astype(np.float32), device=dev)
    zs, ys, xs = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (zs, ys, xs))
    vol = cast(vol)
    mid = torch.einsum("zd,bdhwc->bzhwc", tent_weights(di, d), vol)
    fu = f_u[:, None, None]
    v = (fu * ys[None, None, :] / zs[None, :, None]
         + c_v[:, None, None]) / stride
    u = (fu * xs[None, None, :] / zs[None, :, None]
         + c_u[:, None, None]) / stride
    rows = torch.einsum("bzyh,bzhwc->bzywc", tent_weights(v, vol.shape[2]),
                        mid)
    return torch.einsum("bzxw,bzywc->bzyxc", tent_weights(u, vol.shape[3]),
                        rows)


def depth_tap_conv(x, w, inv, off, relu=True, cast=exact):
    """y[d] = act((x[d-1] W0 + x[d] W1 + x[d+1] W2) * inv + off), zero
    planes past both ends."""
    x, w = cast(x), cast(w)
    z = torch.einsum("bdhwc,cf->bdhwf", x, w[1])
    z = z + F.pad(torch.einsum("bdhwc,cf->bdhwf", x[:, :-1], w[0]),
                  (0, 0, 0, 0, 0, 0, 1, 0))
    z = z + F.pad(torch.einsum("bdhwc,cf->bdhwf", x[:, 1:], w[2]),
                  (0, 0, 0, 0, 0, 0, 0, 1))
    out = z * inv + off
    return torch.relu(out) if relu else out


class StereoFeatureNet(nn.Module):
    def __init__(self, c, cast):
        super().__init__()
        specs = [(3, c, 3, 2, 1, True), (c, c, 3, 1, 1, True),
                 (c, c, 3, 2, 1, True)]
        cin = c
        for i, dil in enumerate((1, 1, 2, 4)):
            specs += [(cin, 2 * c, 3, 1, dil, True),
                      (2 * c, 2 * c, 3, 1, dil, False)]
            if i == 0:
                specs.append((c, 2 * c, 1, 1, 1, False))
            cin = 2 * c
        specs += [(2 * c, c, 1, 1, 1, True)] * 3
        specs += [(5 * c, 2 * c, 3, 1, 1, True), (2 * c, c, 1, 1, 1, False)]
        for i, (ci, co, k, s, dil, relu) in enumerate(specs):
            self.add_module(f"ConvBnRelu_{i}",
                            ConvBnRelu(ci, co, k, s, dil, relu, cast))

    def forward(self, x):
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
    def __init__(self, cin, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, cin, features))


class ConvBnRelu2p1D(nn.Module):
    def __init__(self, cin, features, stride=1, relu=True, cast=exact):
        super().__init__()
        self.spatial = Conv(cin, features, 3, stride, padding="SAME",
                            cast=cast)
        self.depth = DepthKernel(features, features)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.stride, self.relu, self.cast = stride, relu, cast

    def forward(self, x):
        b, d, h, w, c = x.shape
        y = self.spatial(x.reshape(b * d, h, w, c))
        y = y.reshape(b, d, *y.shape[1:])
        if self.stride == 1:
            inv, off = self.FrozenBatchNorm_0.folded()
            return depth_tap_conv(y, self.depth.weight, inv, off, self.relu,
                                  self.cast)
        lo, hi = same_pads(d, 3, self.stride)
        kern = self.cast(self.depth.weight).permute(2, 1, 0)
        z = F.conv3d(F.pad(self.cast(y.permute(0, 4, 1, 2, 3)),
                           (0, 0, 0, 0, lo, hi)),
                     kern[..., None, None], stride=(self.stride, 1, 1))
        z = self.FrozenBatchNorm_0(z.permute(0, 2, 3, 4, 1))
        return torch.relu(z) if self.relu else z


class Score3D(nn.Module):
    def __init__(self, cin, cast):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, cin, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(1))
        self.cast = cast

    def forward(self, x):
        return F.conv3d(self.cast(x.permute(0, 4, 1, 2, 3)),
                        self.cast(self.weight), self.bias, padding=1)[:, 0]


class Hourglass3D(nn.Module):
    def __init__(self, cin, c, cast):
        super().__init__()
        specs = [(cin, c, 1), (c, 2 * c, 2), (2 * c, 2 * c, 1),
                 (2 * c, 2 * c, 2), (2 * c, 2 * c, 1), (2 * c, 2 * c, 1),
                 (2 * c, c, 1)]
        for i, (ci, co, s) in enumerate(specs):
            self.add_module(f"ConvBnRelu2p1D_{i}",
                            ConvBnRelu2p1D(ci, co, s, cast=cast))

    def forward(self, x):
        layer = lambda i, t: getattr(self, f"ConvBnRelu2p1D_{i}")(t)
        x0 = layer(0, x)
        d1 = layer(2, layer(1, x0))
        d2 = layer(4, layer(3, d1))
        u1 = layer(5, resize_trilinear(d2, d1.shape[1:4])) + d1
        u0 = layer(6, resize_trilinear(u1, x0.shape[1:4])) + x0
        return d1, u1, u0


class BEVHead(nn.Module):
    def __init__(self, cin, num_classes, channels, cast):
        super().__init__()
        for i in range(4):
            self.add_module(f"ConvBnRelu_{i}", ConvBnRelu(
                cin if i == 0 else channels, channels, 3, 1, cast=cast))
        self.cls = Conv(channels, num_classes, 3, bias=True, cast=cast)
        self.reg = Conv(channels, 8, 3, bias=True, cast=cast)
        self.centerness = Conv(channels, 1, 3, bias=True, cast=cast)

    def forward(self, bev):
        t = self.ConvBnRelu_1(self.ConvBnRelu_0(bev))
        cls_t, reg_t = self.ConvBnRelu_2(t), self.ConvBnRelu_3(t)
        return self.cls(cls_t), self.reg(reg_t), self.centerness(cls_t)[..., 0]


class DSGN(nn.Module):
    """Normalized stereo pair + (B,) calibration -> depth maps and the BEV
    head's outputs, all float32."""

    def __init__(self, cfg, cast=exact):
        super().__init__()
        self.cfg, self.cast = cfg, cast
        fc, pc, gc = cfg.feature_channels, cfg.psv_channels, cfg.gv_channels
        self.StereoFeatureNet_0 = StereoFeatureNet(fc, cast)
        self.Hourglass3D_0 = Hourglass3D(2 * fc, pc, cast)
        for i, ch in enumerate((2 * pc, 2 * pc, pc)[-cfg.num_depth_preds:]):
            self.add_module(f"depth_score{i}", Score3D(ch, cast))
        for i in range(3):
            self.add_module(f"ConvBnRelu2p1D_{i}", ConvBnRelu2p1D(
                pc if i == 0 else gc, gc, cast=cast))
        self.BEVHead_0 = BEVHead(cfg.num_voxels_y * gc, cfg.num_classes,
                                 cfg.head_channels, cast)

    def forward(self, im_left, im_right, f_u, baseline, c_u, c_v):
        cfg, stride = self.cfg, self.cfg.feature_stride
        planes = depth_planes(cfg, im_left.device)
        fl = self.StereoFeatureNet_0(im_left)
        fr = self.StereoFeatureNet_0(im_right)
        psv = build_psv(fl, fr, f_u, baseline, planes, stride)
        s0, s1, s2 = self.Hourglass3D_0(psv)
        depth_preds = []
        for i, s in enumerate((s0, s1, s2)[-cfg.num_depth_preds:]):
            score = getattr(self, f"depth_score{i}")(s)
            if score.shape[1] != cfg.num_depth_planes:
                score = resize_trilinear(
                    score[..., None], (cfg.num_depth_planes, psv.shape[2],
                                       psv.shape[3]))[..., 0]
            prob = torch.softmax(score, dim=1)
            depth = torch.einsum("bdhw,d->bhw", prob, planes)
            depth_preds.append(resize_bilinear(
                depth[..., None], im_left.shape[1], im_left.shape[2])[..., 0])
        gv_in = self.ConvBnRelu2p1D_0(s2)
        voxels = psv_to_3dgv(gv_in, planes, f_u, c_u, c_v, cfg, stride,
                             self.cast)
        voxels = self.ConvBnRelu2p1D_2(self.ConvBnRelu2p1D_1(voxels))
        b, z, y, x, c = voxels.shape
        bev = voxels.permute(0, 1, 3, 2, 4).reshape(b, z, x, y * c)
        cls, reg, ctr = self.BEVHead_0(bev)
        return {"depth_preds": depth_preds, "bbox_cls": cls, "bbox_reg": reg,
                "bbox_centerness": ctr}


def init_shapes(model: nn.Module):
    """(name, shape, kind) of every parameter, kind one of "kernel" (with
    its fan-in), "one", "zero", "cls_bias": the port's init
    (lecun-normal kernels, BN scale and variance 1, zero biases and
    means, the class bias at -4.59)."""
    out = []
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = p.shape[0] * p.shape[1] if p.dim() == 3 \
                else int(np.prod(p.shape[1:]))
            out.append((name, tuple(p.shape), ("kernel", fan_in)))
        elif name == "BEVHead_0.cls.bias":
            out.append((name, tuple(p.shape), ("const", -4.59)))
        elif leaf in ("scale", "var"):
            out.append((name, tuple(p.shape), ("const", 1.0)))
        else:
            out.append((name, tuple(p.shape), ("const", 0.0)))
    return out


# ------------------------------------------------------------------ loss

def bev_cell_centers(cfg, device):
    xs = torch.linspace(cfg.voxel_x_min, cfg.voxel_x_max, cfg.num_voxels_x,
                        device=device)
    zs = torch.linspace(cfg.voxel_z_min, cfg.voxel_z_max, cfg.num_voxels_z,
                        device=device)
    return torch.meshgrid(zs, xs, indexing="ij")


def bev_targets(boxes3d, num_boxes, cfg):
    """A BEV cell is positive iff its centre lies in a gt box's BEV
    rectangle widened by the centerness radius; ties go to the smallest
    footprint. -> (labels, reg (B,Z,X,8), centerness, pos)."""
    b, g = boxes3d.shape[:2]
    zz, xx = bev_cell_centers(cfg, boxes3d.device)
    valid = torch.arange(g, device=boxes3d.device)[None] < num_boxes[:, None]
    per = lambda v: v[:, None, None, :]
    bx, by, bz, bh, bw, bl, ry, cls_id = boxes3d.unbind(-1)
    dx = xx[None, ..., None] - per(bx)
    dz = zz[None, ..., None] - per(bz)
    cu = dx * torch.cos(per(ry)) - dz * torch.sin(per(ry))
    cv = dx * torch.sin(per(ry)) + dz * torch.cos(per(ry))
    half_l = torch.clamp_min(bl, 0.1) / 2.0 * cfg.centerness_radius
    half_w = torch.clamp_min(bw, 0.1) / 2.0 * cfg.centerness_radius
    inside = (torch.abs(cu) <= per(half_l)) & (torch.abs(cv) <= per(half_w)) \
        & per(valid)
    big = torch.tensor(1e9, device=boxes3d.device)
    cand = torch.where(inside, per(torch.where(valid, bw * bl, big)), big)
    best = torch.argmin(cand, dim=-1)
    pos = inside.any(dim=-1)
    take = lambda v: torch.gather(v, 1, best.reshape(b, -1)).reshape(
        best.shape)
    labels = torch.where(pos, take(cls_id).long(), 0)
    reg = torch.stack([
        take(bx) - xx, take(bz) - zz, take(by),
        torch.log(torch.clamp_min(take(bh), 1e-3)),
        torch.log(torch.clamp_min(take(bw), 1e-3)),
        torch.log(torch.clamp_min(take(bl), 1e-3)),
        torch.sin(take(ry)), torch.cos(take(ry))], dim=-1)
    u = torch.gather(cu, -1, best[..., None])[..., 0]
    v = torch.gather(cv, -1, best[..., None])[..., 0]
    ctr = torch.sqrt(torch.clamp((1 - torch.abs(u) / take(half_l))
                                 * (1 - torch.abs(v) / take(half_w)), 0, 1))
    return labels, reg, torch.where(pos, ctr, 0.0), pos


def smooth_l1(d):
    a = torch.abs(d)
    return torch.where(a < 1.0, 0.5 * d * d, a - 0.5)


def total_loss(out, depth_gt, boxes3d, num_boxes, cfg):
    """The attack's objective: the multi-scale depth smooth-L1 over gt
    depths in (min, max] plus the RPN3D focal / smooth-L1 / centerness
    losses, each over the batch's positives."""
    mask = (depth_gt > cfg.min_depth) & (depth_gt <= cfg.max_depth)
    denom = torch.clamp_min(mask.sum().float(), 1.0)
    total = torch.zeros((), device=depth_gt.device)
    weights = cfg.disp_loss_weights[-len(out["depth_preds"]):]
    for w, pred in zip(weights, out["depth_preds"]):
        total = total + w * (smooth_l1(pred - depth_gt) * mask).sum() / denom
    labels, reg, ctr_t, pos = bev_targets(boxes3d, num_boxes, cfg)
    num_pos = torch.clamp_min(pos.sum().float(), 1.0)
    logits = out["bbox_cls"]
    onehot = ((labels[..., None] - 1) == torch.arange(
        cfg.num_classes, device=logits.device)).float() * pos[..., None]
    p = torch.sigmoid(logits)
    ce = torch.logaddexp(torch.zeros_like(logits), logits) - logits * onehot
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = cfg.focal_alpha * onehot + (1 - cfg.focal_alpha) * (1 - onehot)
    cls_l = (a_t * (1 - p_t) ** cfg.focal_gamma * ce).sum() / num_pos
    reg_l = (smooth_l1(out["bbox_reg"] - reg).sum(-1) * pos).sum() / num_pos
    c = out["bbox_centerness"]
    ctr_l = ((torch.logaddexp(torch.zeros_like(c), c) - c * ctr_t)
             * pos).sum() / num_pos
    return total + cls_l + reg_l + ctr_l


def boxes3d(cars, max_boxes=16):
    """(G, 8) [x, y, z, h, w, l, ry, 1] rows of a pair's Cars, zero-padded,
    and their count."""
    rows = np.zeros((max_boxes, 8), np.float32)
    for k, c in enumerate(cars[:max_boxes]):
        rows[k] = [*c.loc, *c.dims, c.ry, 1.0]
    return rows, min(len(cars), max_boxes)


def pad_frame(img, h, w):
    out = np.zeros((h, w, 3), img.dtype)
    out[:min(h, img.shape[0]), :min(w, img.shape[1])] = \
        img[:h, :w]
    return out


def calib_vectors(n, device):
    """(f_u, baseline, c_u, c_v) of the traffic's calibration, (n,) each."""
    from portbench.frames import P2, P3
    vals = (P2[0, 0], abs((P2[0, 3] - P3[0, 3]) / P2[0, 0]), P2[0, 2],
            P2[1, 2])
    return [torch.full((n,), float(np.float32(v)), device=device)
            for v in vals]


def attack_loss_and_grad(model, cfg, il255, ir255, boxes, nbox):
    """Loss and its gradient w.r.t. both 255-space views at one iterate:
    (B, H, W, 3) float32 pixels in, as the attack CLI feeds the model."""
    mean = torch.tensor(cfg.input.mean, device=il255.device) * 255.0
    std = torch.tensor(cfg.input.std, device=il255.device) * 255.0
    xl = il255.detach().requires_grad_(True)
    xr = ir255.detach().requires_grad_(True)
    calib = calib_vectors(il255.shape[0], il255.device)
    out = model((xl - mean) / std, (xr - mean) / std, *calib)
    depth = torch.zeros(il255.shape[:3], device=il255.device)
    loss = total_loss(out, depth, boxes, nbox, cfg)
    gl, gr = torch.autograd.grad(loss, (xl, xr))
    return loss.detach(), gl, gr


def n_params(shapes) -> int:
    return sum(math.prod(s) for _, s, _ in shapes)


def init_shapes_of(config: dict):
    """`init_shapes` of the configuration file's model, built on the meta
    device (nothing allocated)."""
    with torch.device("meta"):
        return init_shapes(DSGN(globals()["config"](config["model"])))


def load(config: dict, ckpt: str, device, cast=exact) -> DSGN:
    """The reference at the configuration's sizes with the weights file
    the program was given, frozen, float32."""
    model = DSGN(globals()["config"](config["model"]), cast)
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True))
    return model.to(device).requires_grad_(False).eval()


def flops_per_unit(config: dict, traffic: dict, kind: str) -> int:
    """Operations of one unit of the traffic's work, counted on this
    reference on the meta device: a sweep's pair is `iters` forward
    passes with the loss and its input gradient at batch 1; a patch
    step one forward and input-gradient pass over the traffic's `batch`
    pairs."""
    from portbench.counts import model_flops
    cfg = globals()["config"](config["model"])
    with torch.device("meta"):
        model = DSGN(cfg).requires_grad_(False)
    h, w = cfg.input.height, cfg.input.width

    def attack():
        x = torch.zeros(1, h, w, 3, device="meta")
        attack_loss_and_grad(model, cfg, x, x.clone(),
                             torch.zeros(1, 16, 8, device="meta"),
                             torch.ones(1, dtype=torch.long, device="meta"))

    if kind == "patch":
        return model_flops(attack) * traffic["batch"]
    return model_flops(attack) * traffic["iters"]

