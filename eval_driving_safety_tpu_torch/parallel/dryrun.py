"""The multi-rank dry run: one sharded universal-patch step of DSGN on a
(data, model) mesh, the patch saved and restored bit for bit, and a
second step from the restored patch.

Twin of the DSGN part of the JAX package's `__graft_entry__.
_dryrun_multichip_impl`: the batch (one row a data row) split over the
mesh's data rows, the plane-sweep volume's depth planes over its model
ranks (parallel/volume.py), the patch gradient gathered over the data
rows (`sharded_patch_step`). Weights are the seeded init, frozen; the
inputs seeded uniform frames with the JAX run's calibration, box, depth
and patch geometry. Run it as

    torchrun --nproc_per_node N -m eval_driving_safety_tpu_torch.parallel.dryrun \\
        [--n-model 2] [--scale tiny|dryrun|paper] [--device cuda]

(`--device cpu` runs the kernels' plain versions over gloo). The mesh is
(N // n_model, n_model), n_model by default as the JAX run picks it;
`dryrun` is the JAX run's "2x-tiny" geometry
(192 x 640, 32 planes, 76 x 72 x 8 voxels, widths 16/16/16/32), `paper`
DSGNConfig.full(). Rank 0 prints the mesh, the loss and "ckpt-restore
OK" as JAX prints them, after a JSON line of the run's numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.parallel import sharding as S
from eval_driving_safety_tpu_torch.parallel import volume as V


def scale_cfg(scale: str) -> DSGNConfig:
    tiny = DSGNConfig.tiny()
    if scale == "tiny":
        return tiny
    if scale == "dryrun":
        return dataclasses.replace(
            tiny, height=192, width=640, feature_channels=16,
            num_depth_planes=32, psv_channels=16, gv_channels=16,
            head_channels=32, num_voxels_x=76, num_voxels_z=72,
            num_voxels_y=8,
            input=dataclasses.replace(tiny.input, height=192, width=640))
    return DSGNConfig.full()


def example_inputs(cfg: DSGNConfig, batch: int, device):
    """Seeded frames in [0, 1) and the JAX run's calibration (f 720, b
    0.54, the image centre), one Car box and depth 20 m everywhere."""
    g = torch.Generator().manual_seed(0)
    h, w = cfg.height, cfg.width
    im_l, im_r = (torch.rand((batch, h, w, 3), generator=g)
                  for _ in range(2))
    calib = tuple(torch.full((batch,), v) for v in (720.0, 0.54, w / 2.0,
                                                    h / 2.0))
    boxes = torch.zeros((batch, 4, 8))
    boxes[:, 0] = torch.tensor([2.0, 1.6, 20.0, 1.5, 1.7, 4.0, 0.3, 1.0])
    num_boxes = torch.ones((batch,), dtype=torch.int64)
    depth = torch.full((batch, h, w), 20.0)
    return tuple(t.to(device) if isinstance(t, torch.Tensor) else
                 tuple(c.to(device) for c in t)
                 for t in (im_l, im_r, calib, boxes, num_boxes, depth))


def run(mesh: S.Mesh, cfg: DSGNConfig) -> dict:
    """The two steps and the checkpoint round trip on this rank; returns
    the numbers rank 0 prints. Raises where the restored patch is not the
    saved one bit for bit, a loss is not finite or the patch did not
    move."""
    from eval_driving_safety_tpu_torch.attack.patch import (
        init_patch, sample_patch_centers)
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    from eval_driving_safety_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    dev = mesh.device
    model = DSGN(cfg, volume_constraint=V.constrain_psv(mesh))
    model = model.init_weights(0).to(dev).requires_grad_(False).eval()
    batch = mesh.n_data
    im_l, im_r, calib, boxes, num_boxes, depth = example_inputs(
        cfg, batch, dev)
    _, radius, patch = init_patch(cfg.height, 0.2)
    centers_l, centers_r = sample_patch_centers(
        torch.Generator().manual_seed(1), batch, cfg.height, cfg.width,
        radius, disparity_shift=-8.0)
    sharding = S.dp_sharding(mesh, batch)
    with sharding:
        il, ir, cl, cr, rc, rb, rn, rd = S.shard_batch(
            (im_l, im_r, centers_l, centers_r, calib, boxes, num_boxes,
             depth), sharding)

        def loss_fn(vl, vr):
            out = model(vl, vr, *rc)
            return dsgn_total_loss(out, rd, rb, rn, cfg)[0]
        step = S.sharded_patch_step(loss_fn, mesh, alpha=1e3, eps=8 / 255)
        V.reset_traffic()
        t0 = time.perf_counter()
        new_patch, loss = step(patch, il, ir, cl, cr)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
        traffic = {k: dict(v) for k, v in V.traffic.items()}

        # the patch through the port's checkpoint files: rank 0 writes,
        # every rank restores and must get its own patch's bits
        ckdir = [tempfile.mkdtemp(prefix="dryrun_ck") if mesh.rank == 0
                 else None]
        if dist.is_initialized():
            dist.broadcast_object_list(ckdir, src=0)
        path = os.path.join(ckdir[0], "patch")
        if mesh.rank == 0:
            save_checkpoint(path, {"patch": new_patch.cpu(), "epoch": 1})
        S.barrier()
        restored = restore_checkpoint(path)
        if restored["epoch"] != 1 or restored["patch"].numpy().tobytes() \
                != new_patch.cpu().numpy().tobytes():
            raise RuntimeError("the restored patch differs from the saved "
                               "sharded state")
        new_patch2, loss2 = step(restored["patch"], il, ir, cl, cr)
    S.barrier()
    if mesh.rank == 0:
        shutil.rmtree(ckdir[0])
    moved = float((new_patch - patch).abs().max())
    if not (math.isfinite(float(loss)) and math.isfinite(float(loss2))):
        raise RuntimeError(f"a sharded patch step's loss is not finite: "
                           f"{float(loss)}, {float(loss2)}")
    if not moved > 0.0:
        raise RuntimeError("the patch did not update")
    return {"mesh": {"data": mesh.n_data, "model": mesh.n_model},
            "h": cfg.height, "w": cfg.width, "D": cfg.num_depth_planes,
            "loss": float(loss), "loss2": float(loss2),
            "patch_max_change": moved,
            "second_step_moved": float((new_patch2 - new_patch).abs().max()),
            "first_step_s": step_s, "traffic": traffic}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-model", type=int, default=None,
                   help="model ranks a data row (the planes' split; by "
                        "default 2 where the world is even and at least "
                        "4, else 1, as the JAX dry run picks)")
    p.add_argument("--scale", choices=("tiny", "dryrun", "paper"),
                   default="dryrun")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions")
    args = p.parse_args(argv)
    mesh = S.init_process_group(args.device)
    try:
        if args.n_model is None:
            args.n_model = 2 if mesh.world % 2 == 0 and mesh.world >= 4 \
                else 1
        if mesh.world % args.n_model:
            raise SystemExit(f"--n-model {args.n_model} does not divide a "
                             f"world of {mesh.world} ranks")
        mesh = dataclasses.replace(
            S.make_mesh(mesh.world // args.n_model, args.n_model),
            device=mesh.device)
        rec = run(mesh, scale_cfg(args.scale))
        if mesh.rank == 0:
            print(json.dumps({"dryrun": rec}), flush=True)
            print(f"dryrun_multichip({mesh.world}): DSGN mesh="
                  f"{rec['mesh']} h={rec['h']} w={rec['w']} D={rec['D']} "
                  f"loss={rec['loss']:.4f} ckpt-restore OK", flush=True)
    finally:
        S.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
