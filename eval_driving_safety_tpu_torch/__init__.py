"""PyTorch/CUDA port of `eval_driving_safety_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference and is never imported
here. This package ports the DSGN PGD attack sweep
(`python -m eval_driving_safety_tpu_torch.cli.pgd_attack --detector dsgn`)
and DSGN training (`cli.train_detector --detector dsgn`, with its depth
ground truth from `cli.make_depth_gt`):

  data/      KITTI frames, u8 batches, sign replay and PNG sweep output
  ops/       cost volumes; the hand-written CUDA kernels (psv_warp,
             depthconv) with a plain PyTorch version each, used for CPU
             tensors only; the kernel loader (_cuda)
  csrc/      CUDA C++ kernel sources, built with nvcc at first use
  models/    DSGN (channel-last, same parameter names as the Flax model)
             and its loss
  attack/    PGD engine with packed-sign transfer and host replay
  inference/ the velodyne reader of the depth ground truth
  utils/     Flax -> PyTorch weight bridge; trainer checkpoints
  cli/       the attack, training and depth ground-truth entry points

Every entry point takes a `device` (default "cuda"); a CUDA tensor goes
through the kernels or the call raises.
"""

__version__ = "0.1.0"
