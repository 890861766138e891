"""VGG-16 conv features on NHWC tensors, the frozen backbone of the
dynamic-vehicle classifier.

Counterpart of eval_driving_safety_tpu/models/vgg.py, with its module
names (`conv{stage}_{i}`): thirteen 3x3 SAME convs with biases and ReLU,
and a 2x2 VALID max pool after each of the five stages, so a 224x224
input gives (7, 7, 512).
"""
from __future__ import annotations

import torch
from torch import nn

from eval_driving_safety_tpu_torch.models.common import Conv, max_pool

VGG16_LAYOUT = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):

    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for stage, (ch, n) in enumerate(VGG16_LAYOUT):
            for i in range(n):
                self.add_module(f"conv{stage + 1}_{i + 1}",
                                Conv(cin, ch, 3, bias=True))
                cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage, (_, n) in enumerate(VGG16_LAYOUT):
            for i in range(n):
                x = torch.relu(getattr(self, f"conv{stage + 1}_{i + 1}")(x))
            x = max_pool(x, 2, 2, 0)
        return x
