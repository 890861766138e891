"""PyTorch/CUDA port of `eval_driving_safety_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference and is never imported
here. This package ports its pipeline: the PGD and patch attacks, detection
export with KITTI AP and training of DSGN and Stereo R-CNN, the scene
classifiers, and the safety stage
(`python -m eval_driving_safety_tpu_torch.cli.<stage>`):

  data/      KITTI frames, u8 batches, sign replay and PNG sweep output
  ops/       cost volumes; the hand-written CUDA kernels (psv_warp,
             depthconv) with a plain PyTorch version each, used for CPU
             tensors only; the kernel loader (_cuda)
  csrc/      CUDA C++ kernel sources, built with nvcc at first use
  models/    DSGN (channel-last, same parameter names as the Flax model)
             and its loss
  attack/    PGD engine with packed-sign transfer and host replay
  inference/ detection decode and export, depth export, visualization
  utils/     Flax -> PyTorch weight bridge; trainer checkpoints
  safety/    the safety stage on the host: CommonRoad XML, scenario
             conversion, A* planning, collision checking, the five
             metrics, plots
  native/    the C++ collision core, built with g++ at first use
  cli/       the entry points: attacks, training, predict, classifiers,
             and the safety stage

Every model entry point takes a `device` (default "cuda"); a CUDA tensor
goes through the kernels or the call raises. The safety stage's entry
points run on the host and take none.
"""

__version__ = "0.1.0"
