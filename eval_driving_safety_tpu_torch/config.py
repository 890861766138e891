"""Configuration of the ported DSGN attack path.

Field-for-field the DSGN, input and PGD configs of the JAX package, so a
configuration means the same model in both. Two fields name the
formulation of the volume ops, and their defaults differ from the JAX
package's: there the defaults were chosen for the TPU's matrix unit, here
"kernel" selects the hand-written CUDA kernels (ops.psv_warp,
ops.depthconv). The alternatives are the JAX defaults' formulations in
plain PyTorch library ops.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


# DSGN pipeline: RGB in [0,1], ImageNet normalization
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DSGNInputConfig:
    """DSGN input convention: frames padded to height x width."""
    height: int = 384
    width: int = 1248
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


@dataclass(frozen=True)
class DSGNConfig:
    """DSGN: stereo features -> plane-sweep volume -> (2+1)D hourglass ->
    multi-scale depth + 3D geometric volume -> BEV detection head.

    `tiny()` for tests, the default mid-size config, `full()` for the
    paper-scale volumes."""
    height: int = 384
    width: int = 1248
    feature_channels: int = 32               # stereo feature dim at stride 4
    feature_stride: int = 4
    # plane-sweep volume
    num_depth_planes: int = 64
    min_depth: float = 2.0
    max_depth: float = 59.6
    psv_channels: int = 32                   # hourglass channels
    num_depth_preds: int = 3
    disp_loss_weights: Tuple[float, ...] = (0.5, 0.7, 1.0)
    # 3D geometric volume (camera frame: x right, z forward)
    voxel_x_min: float = -30.4
    voxel_x_max: float = 30.4
    voxel_z_min: float = 2.0
    voxel_z_max: float = 59.6
    voxel_y_min: float = -1.0
    voxel_y_max: float = 3.0
    num_voxels_x: int = 152
    num_voxels_z: int = 144
    num_voxels_y: int = 8
    gv_channels: int = 32
    # detection head
    num_classes: int = 1                     # Car
    head_channels: int = 64
    # loss
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    centerness_radius: float = 1.5
    # postprocessor
    score_thresh: float = 0.1
    nms_thresh: float = 0.3
    max_detections: int = 50
    input: DSGNInputConfig = field(default_factory=DSGNInputConfig)
    loss_disp: bool = True
    rpn3d_enable: bool = True
    dtype: str = "bfloat16"
    # recompute the hourglass in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    # PSV warp and the depth stage of stride-1 (2+1)D convs. The JAX
    # config's other values ("einsum", "transpose") compute the same
    # functions with library products; the port takes only "kernel": the
    # CUDA kernels of ops.psv_warp and ops.depthconv, whose plain versions
    # serve CPU tensors.
    psv_method: str = "kernel"
    depthconv_method: str = "kernel"

    @staticmethod
    def tiny() -> "DSGNConfig":
        return DSGNConfig(
            height=96, width=320, feature_channels=8, num_depth_planes=16,
            psv_channels=8, gv_channels=8, head_channels=16,
            num_voxels_x=40, num_voxels_z=36, num_voxels_y=4,
            input=DSGNInputConfig(height=96, width=320),
        )

    @staticmethod
    def full(remat: bool = False) -> "DSGNConfig":
        """Paper-scale volumes: 96 planes, 304x288x10 voxels at 384x1248."""
        return DSGNConfig(
            feature_channels=32, num_depth_planes=96,
            num_voxels_x=304, num_voxels_z=288, num_voxels_y=10,
            remat=remat,
        )


@dataclass(frozen=True)
class PGDConfig:
    """PGD L-inf defaults for DSGN: iter 4, alpha 1/255, eps 0.3 in [0,1]."""
    num_iters: int = 4
    alpha: float = 1.0 / 255.0
    eps: float = 0.3
    pixel_min: float = 0.0
    pixel_max: float = 1.0
    save_intermediate: bool = True
