"""Configuration of the ported DSGN, Stereo R-CNN, classifier and safety
paths.

Field-for-field the DSGN, Stereo R-CNN, input, PGD, patch, classifier,
scenario and planner configs of the JAX package, so a configuration means
the same model in both. Two fields name the formulation of the volume
ops, and their defaults differ from the JAX package's: there the
defaults were chosen for the TPU's matrix unit, here "kernel" selects
the hand-written CUDA kernels (ops.psv_warp, ops.depthconv). The
alternatives are the JAX defaults' formulations in plain PyTorch library
ops.
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


# Stereo R-CNN pipeline: BGR pixels in [0,255] minus per-channel means
SRCNN_PIXEL_MEANS_BGR: Tuple[float, float, float] = (102.9801, 115.9465,
                                                     122.7717)


@dataclass(frozen=True)
class SRCNNInputConfig:
    """Stereo R-CNN input convention: frames resized to 600 rows and
    cropped or padded to a width that is a multiple of 32 (the FPN's
    coarsest stride)."""
    height: int = 600
    width: int = 1984
    pixel_means_bgr: Tuple[float, float, float] = SRCNN_PIXEL_MEANS_BGR


@dataclass(frozen=True)
class StereoRCNNConfig:
    """Stereo R-CNN: siamese ResNet-101 + FPN, joint stereo RPN, and the
    per-roi box / dimension-orientation / keypoint heads, with the loss
    path always on. `tiny()` for tests."""
    num_classes: int = 2                     # background + Car
    backbone_blocks: Tuple[int, ...] = (3, 4, 23, 3)   # resnet101
    backbone_width: int = 64
    fpn_channels: int = 256
    pooling_size: int = 7
    kpts_grid: int = 28
    kpts_convs: int = 4
    # "bfloat16": the conv trunk and heads compute in bf16; decode,
    # softmax and losses stay f32. The CLIs default to bf16, --fp32 keeps
    # f32 throughout
    dtype: str = "float32"
    # "s2d" or "conv7": two formulations of the 7x7/2 stem conv in the JAX
    # package (the space-to-depth one suits the TPU's matrix unit); they
    # compute the same function, which the port computes as one 7x7/2
    # conv for either value
    stem_method: str = "conv7"
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scales: Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    feat_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    # proposals
    pre_nms_top_n: int = 2000
    post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 8.0
    # anchor-target sampling
    rpn_batch_size: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    # proposal-target sampling
    roi_batch_size: int = 128
    roi_fg_fraction: float = 0.25
    roi_fg_thresh: float = 0.5
    roi_bg_thresh_hi: float = 0.5
    roi_bg_thresh_lo: float = 0.0
    bbox_normalize_means: Tuple[float, float, float, float] = (0.0, 0.0,
                                                               0.0, 0.0)
    bbox_normalize_stds: Tuple[float, float, float, float] = (0.1, 0.1,
                                                              0.2, 0.2)
    max_gt_boxes: int = 30
    # test time
    score_thresh: float = 0.05
    vis_thresh: float = 0.7
    test_nms_thresh: float = 0.4
    max_detections: int = 50
    input: SRCNNInputConfig = field(default_factory=SRCNNInputConfig)

    @staticmethod
    def tiny() -> "StereoRCNNConfig":
        """Small config for CPU tests: shallow backbone, few rois."""
        return StereoRCNNConfig(
            backbone_blocks=(1, 1, 1, 1), backbone_width=8, fpn_channels=16,
            pre_nms_top_n=128, post_nms_top_n=32, rpn_batch_size=32,
            roi_batch_size=16, max_gt_boxes=8, max_detections=8,
            input=SRCNNInputConfig(height=96, width=320))


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


@dataclass(frozen=True)
class PatchConfig:
    """Universal circular patch defaults of the DSGN patch attack: eps
    8/255 per step, 2 steps per batch, 80 epochs, ratio 0.2, step
    0.5 * 1e3 * g."""
    ratio: float = 0.2
    eps: float = 8.0 / 255.0
    iters_per_batch: int = 2
    epochs: int = 80
    step_scale: float = 0.5 * 1e3
    # placement: row in [0.4*H, H-r-1]; col in [0.2, 0.8]*W
    row_band: Tuple[float, float] = (0.4, 1.0)
    col_band: Tuple[float, float] = (0.2, 0.8)
    # right-image centre shift: -40 * 1.6 px
    disparity_shift: float = -64.0
    # the targeted ghost car: its 2D box (x1, y1, x2, y2) and its 3D box
    # (h, w, l, x, y, z, ry)
    ghost_box2d: Tuple[float, float, float, float] = (569.33, 180.88,
                                                      613.91, 225.02)
    ghost_box3d: Tuple[float, ...] = (1.65, 1.67, 3.64, -0.78, 1.98, 29.11,
                                      -1.60)


# column bands of the eval-time patch placement (--patch_mode): fractions
# of the width between which the centre column is drawn
PLACEMENT_BANDS = {
    "random": (0.2, 0.8),
    "sp_left": (0.2, 0.4),
    "sp_straight": (0.4, 0.6),
    "sp_right": (0.6, 0.8),
}


@dataclass(frozen=True)
class RoadTypeConfig:
    """highway (1) / street (0) classifier on full left frames: a frozen
    ResNet-50 with a 1-unit head, BCE, Adam 1e-3 scaled by 0.1 after
    epochs 5, 10 and 15, the dataset's own normalization."""
    image_size: int = 224
    mean: Tuple[float, float, float] = (0.3775, 0.3923, 0.3839)
    std: Tuple[float, float, float] = (0.3110, 0.3154, 0.3180)
    lr: float = 1e-3
    lr_milestones: Tuple[int, ...] = (5, 10, 15)
    lr_gamma: float = 0.1
    dropout: float = 0.5
    epochs: int = 20
    batch_size: int = 32
    ckpt_every: int = 5


@dataclass(frozen=True)
class DynamicVehicleConfig:
    """moving (1) / static (0) classifier on square vehicle crops: frozen
    VGG-16 features, 25088 -> 4096 -> 1, Adam 1e-6 halved after epochs 6
    and 10. No `ckpt_every`: the training CLI saves every 5 epochs."""
    image_size: int = 224
    mean: Tuple[float, float, float] = (0.3091, 0.3181, 0.3248)
    std: Tuple[float, float, float] = (0.2328, 0.2308, 0.2337)
    lr: float = 1e-6
    lr_halve_epochs: Tuple[int, ...] = (6, 10)
    dropout: float = 0.1
    epochs: int = 12
    batch_size: int = 32
    crop_margin: int = 4                     # crop side = max(w, h) + 4


# ---------------------------------------------------------------------------
# Safety evaluation: scenario conversion and the planner
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioConfig:
    """KITTI labels -> CommonRoad scenarios: the street and highway speed
    bands of a dynamic obstacle's constant-velocity rollout, its steps,
    and the label classes that become obstacles."""
    street_vmin: float = 6.0
    street_vmax: float = 8.0
    highway_vmin: float = 11.0
    highway_vmax: float = 13.0
    dt: float = 0.1
    dynamic_rollout_steps: int = 19
    obstacle_classes: Tuple[str, ...] = ("Car", "Van", "Truck", "Misc")


@dataclass(frozen=True)
class PlannerConfig:
    """A* over the BMW 320i's kinematic single-track motion primitives.
    Frozen: `safety.primitives.primitives_for_band` caches on it."""
    dt: float = 0.1
    primitive_duration: float = 0.5
    steering_min: float = -1.066
    steering_max: float = 1.066
    steering_step: float = 0.36
    # (vmin, vmax, vstep); a vstep of 0 samples the endpoints only
    street_v: Tuple[float, float, float] = (6.0, 8.0, 0.0)
    highway_v: Tuple[float, float, float] = (11.0, 13.0, 2.0)
    max_tree_depth: int = 100
    max_expansions: int = 20000
    # the visited set's bucket sizes (x/y metres, psi/sa radians, v m/s):
    # coarser buckets prune more states, finer ones search more of the
    # automaton
    visited_xy: float = 0.1
    visited_angle: float = 0.02
    visited_v: float = 0.1
