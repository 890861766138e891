"""Box-regression helpers used by the DSGN loss."""
from __future__ import annotations

import torch


def smooth_l1(diff: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 with the Faster-R-CNN sigma convention."""
    s2 = sigma * sigma
    absd = torch.abs(diff)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * diff * diff,
                       absd - 0.5 / s2)
