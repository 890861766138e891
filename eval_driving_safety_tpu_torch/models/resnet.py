"""ResNet backbones on NHWC tensors, with frozen BatchNorm: ResNet-101
for Stereo R-CNN (and ResNet-50).

Counterpart of eval_driving_safety_tpu/models/resnet.py, with the Flax
module names. The stem is one 7x7/2 conv for both of the config's
`stem_method` values: the JAX package's "s2d" form is an exact
reformulation of the same conv for the TPU's matrix unit, on the same
`stem_conv` kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from eval_driving_safety_tpu_torch.models.common import (Conv,
                                                         FrozenBatchNorm,
                                                         max_pool)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x width) with a projection shortcut
    where the shape changes."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        out_ch = features * 4
        self.Conv_0 = Conv(cin, features, 1, dtype=dtype)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride, dtype=dtype)
        self.FrozenBatchNorm_1 = FrozenBatchNorm(features)
        self.Conv_2 = Conv(features, out_ch, 1, dtype=dtype)
        self.FrozenBatchNorm_2 = FrozenBatchNorm(out_ch)
        if cin != out_ch or stride != 1:
            self.downsample_conv = Conv(cin, out_ch, 1, stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.FrozenBatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.FrozenBatchNorm_1(self.Conv_1(y)))
        y = self.FrozenBatchNorm_2(self.Conv_2(y))
        res = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + res)


class ResNet(nn.Module):
    """(c2, c3, c4, c5) at strides 4/8/16/32 with 4, 8, 16 and 32 times
    `width` channels."""

    def __init__(self, block_counts: Tuple[int, ...] = (3, 4, 23, 3),
                 width: int = 64, in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        self.stem_conv = Conv(in_channels, width, 7, 2, dtype=dtype)
        self.stem_bn = FrozenBatchNorm(width)
        cin = width
        for stage, n_blocks in enumerate(block_counts):
            features = width * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_block{b}",
                                Bottleneck(cin, features, stride, dtype))
                cin = features * 4
        self.block_counts = tuple(block_counts)

    def forward(self, x: torch.Tensor):
        y = torch.relu(self.stem_bn(self.stem_conv(x)))
        # (1, 1) padding, torch's MaxPool2d(3, 2, 1) grid
        y = max_pool(y, 3, 2, 1)
        feats = []
        for stage, n_blocks in enumerate(self.block_counts):
            for b in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_block{b}")(y)
            feats.append(y)
        return tuple(feats)


def resnet50(**kw) -> ResNet:
    return ResNet(block_counts=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(block_counts=(3, 4, 23, 3), **kw)
