"""Feature Pyramid Network on NHWC tensors.

Counterpart of eval_driving_safety_tpu/models/fpn.py: 1x1 laterals,
bilinear upsample-and-add (half-pixel centres; not an exact 2x where a
level has an odd size, 19 -> 38 -> 75 rows at 600), 3x3 smoothing, and
p6 = every second row and column of p5.
"""
from __future__ import annotations

import torch
from torch import nn

from eval_driving_safety_tpu_torch.models.common import Conv, resize_bilinear


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048),
                 out_channels: int = 256, dtype=torch.float32):
        super().__init__()
        c2, c3, c4, c5 = in_channels

        def lat(cin):
            return Conv(cin, out_channels, 1, bias=True, dtype=dtype)

        def smooth():
            return Conv(out_channels, out_channels, 3, bias=True, dtype=dtype)

        self.toplayer = lat(c5)
        self.latlayer1 = lat(c4)
        self.latlayer2 = lat(c3)
        self.latlayer3 = lat(c2)
        self.smooth1, self.smooth2, self.smooth3 = smooth(), smooth(), \
            smooth()

    def forward(self, c2, c3, c4, c5):
        def up_add(top, lateral):
            return resize_bilinear(top, lateral.shape[1],
                                   lateral.shape[2]) + lateral

        p5 = self.toplayer(c5)
        p4 = self.smooth1(up_add(p5, self.latlayer1(c4)))
        p3 = self.smooth2(up_add(p4, self.latlayer2(c3)))
        p2 = self.smooth3(up_add(p3, self.latlayer3(c2)))
        p6 = p5[:, ::2, ::2, :]
        return p2, p3, p4, p5, p6
