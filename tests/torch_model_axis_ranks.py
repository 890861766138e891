"""Rank code of tests/test_torch_model_axis.py: the model axis
(parallel/volume.py) as the ranks of a gloo launch (`python
tests/torch_model_axis_ranks.py OUT WEIGHTS_DIR`, one process per rank
with the torchrun environment, chip_smoke.launch_ranks). At world 2 a
rank runs the primitives on the (1, 2) mesh, the sharded ops of the tiny
DSGN against their whole versions, the tiny DSGN and the tiny compat model
on the (1, 2) mesh; at world 4 the primitives on the (1, 4) mesh and the
tiny DSGN on the (2, 2) mesh. Each rank writes its results to OUT with
"{rank}" replaced by its rank. Imports no JAX: the inputs are seeded numpy
arrays (made here, and by the test for the JAX models), the weights the
state dicts the test saved in WEIGHTS_DIR. fp32 throughout."""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from eval_driving_safety_tpu_torch.config import DSGNConfig  # noqa: E402
from eval_driving_safety_tpu_torch.parallel import sharding as S  # noqa
from eval_driving_safety_tpu_torch.parallel import volume as V  # noqa

MEAN255 = np.asarray((0.485, 0.456, 0.406), np.float32) * 255.0
STD255 = np.asarray((0.229, 0.224, 0.225), np.float32) * 255.0
# the halos the models take, and a wider one
HALOS = ((1, 1), (0, 1), (1, 0), (2, 1))
# the model tests' batch: split over the data rows of a (2, 2) mesh,
# whole on each rank of a (1, 2) one
BATCH = 2


def tiny_cfg(remat=False):
    return dataclasses.replace(DSGNConfig.tiny(), dtype="float32",
                               remat=remat)


def model_inputs(b=BATCH):
    """A seeded stereo batch in [0, 255] and its targets, as
    tests/test_torch_dsgn.py makes them, with the second row's
    right view shifted further and its own box."""
    rng = np.random.RandomState(0)
    h, w = 96, 320
    il = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    ir = np.stack([np.roll(il[i], -6 - 3 * i, axis=1) for i in range(b)])
    ir = np.clip(ir + rng.randint(-8, 9, il.shape), 0, 255).astype(
        np.float32)
    calib = tuple(np.full((b,), v, np.float32)
                  for v in (180.0, 0.54, 160.0, 48.0))
    depth = np.where(rng.rand(b, h, w) < 0.5, rng.uniform(1.0, 70.0,
                                                          (b, h, w)),
                     0.0).astype(np.float32)
    boxes = np.zeros((b, 4, 8), np.float32)
    boxes[:, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    boxes[0, 1] = [-6.0, 1.5, 30.0, 1.6, 1.8, 3.8, -1.2, 1.0]
    nb = np.array([2] + [1] * (b - 1), np.int32)
    return il, ir, calib, depth, boxes, nb


def compat_inputs():
    """tests/test_torch_dsgn_compat.py's frame pair and targets."""
    rng = np.random.RandomState(6)
    il = rng.rand(1, 96, 320, 3).astype(np.float32) * 4 - 2
    ir = np.roll(il, -6, axis=2) + rng.randn(*il.shape).astype(
        np.float32) * 0.1
    calib = [np.full((1,), v, np.float32)
             for v in (180.0, 0.54, 160.0, 48.0)]
    boxes = np.zeros((1, 4, 8), np.float32)
    boxes[0, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    nb = np.array([1], np.int32)
    depth = np.where(np.random.RandomState(3).rand(1, 96, 320) < 0.5, 20.0,
                     0.0).astype(np.float32)
    return il, ir, calib, depth, boxes, nb


def primitive_inputs(n):
    """A (2, 4n, 3, 5) volume (4 planes a rank), a cotangent of it, and a
    tensor of 1 + 2 + ... + n planes (rank m holding m + 1) with its
    cotangent."""
    rng = np.random.RandomState(n)
    vol = rng.randn(2, 4 * n, 3, 5).astype(np.float32)
    ragged = rng.randn(2, n * (n + 1) // 2, 3).astype(np.float32)
    return vol, rng.randn(*vol.shape).astype(np.float32), ragged, \
        rng.randn(*ragged.shape).astype(np.float32)


def halo_cotangent(n, rank, lo, hi):
    """The seeded cotangent of rank `rank`'s (2, lo + 4 + hi, 3, 5)
    halo-exchanged planes."""
    rng = np.random.RandomState(100 * n + 10 * rank + 3 * lo + hi)
    return rng.randn(2, lo + 4 + hi, 3, 5).astype(np.float32)


def grad(loss, x):
    return torch.autograd.grad(loss, x)[0].numpy()


def primitives(mesh, res):
    """Each primitive on this rank's slice, forward and input gradient."""
    shard = V.VolumeShard(mesh)
    n, m = shard.n, shard.rank
    vol, cot, ragged, rcot = (torch.from_numpy(a)
                              for a in primitive_inputs(n))
    mine = slice(4 * m, 4 * m + 4)
    tag = f"w{n}_"
    # copy_to_model: the whole tensor in, a sharded consumer of it
    x = vol.clone().requires_grad_(True)
    y = V.copy_to_model(x, shard)
    res[tag + "copy_fwd"] = y.detach().numpy()
    res[tag + "copy_grad"] = grad((y[:, mine] * cot[:, mine]).sum(), x)
    # gather_planes: this rank's planes in, a replicated consumer
    x = vol[:, mine].clone().requires_grad_(True)
    y = V.gather_planes(x, shard)
    res[tag + "gather_fwd"] = y.detach().numpy()
    res[tag + "gather_grad"] = grad((y * cot).sum(), x)
    # ... with other sizes on each rank
    sizes = list(range(1, n + 1))
    start = sum(sizes[:m])
    x = ragged[:, start:start + m + 1].clone().requires_grad_(True)
    y = V.gather_planes(x, shard, sizes=sizes)
    res[tag + "ragged_fwd"] = y.detach().numpy()
    res[tag + "ragged_grad"] = grad((y * rcot).sum(), x)
    for lo, hi in HALOS:
        x = vol[:, mine].clone().requires_grad_(True)
        y = V.halo_exchange(x, shard, lo, hi)
        c = torch.from_numpy(halo_cotangent(n, m, lo, hi))
        res[tag + f"halo{lo}{hi}_fwd"] = y.detach().numpy()
        res[tag + f"halo{lo}{hi}_grad"] = grad((y * c).sum(), x)


def _pair(res, name, fn, whole_in, cut_in, cut_out, replicated=False):
    """fn on the whole input and, sharded, on this rank's slice of it
    (`cut_in`): the rank's output against the whole output's slice
    `cut_out` (the whole output where `replicated`), and the rank's input
    gradient against the whole gradient's slice, under one seeded
    cotangent of the whole output."""
    x = whole_in.clone().requires_grad_(True)
    want = fn(x, None)
    cot = torch.from_numpy(np.random.RandomState(len(name)).randn(
        *want.shape).astype(np.float32))
    want_g = grad((want * cot).sum(), x)
    xs = whole_in[cut_in].clone().requires_grad_(True)
    got = fn(xs, True)
    c = cot if replicated else cot[cut_out]
    res["op_" + name] = np.stack([
        got.detach().numpy(),
        (want if replicated else want[cut_out]).detach().numpy()])
    res["op_" + name + "_grad"] = np.stack([grad((got * c).sum(), xs),
                                            want_g[cut_in]])


def sharded_ops(mesh, res):
    """The tiny DSGN's sharded ops against their whole versions: the
    stride-1 and stride-2 depth stages, the D upsample, Score3D, the
    soft-argmin over gathered planes and the 3D geometric volume."""
    from eval_driving_safety_tpu_torch.models.common import resize_trilinear
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.ops.cost_volume import (
        depth_planes, psv_to_3dgv, soft_argmin_depth)
    cfg = tiny_cfg()
    shard = V.VolumeShard(mesh)
    model = DSGN(cfg).init_weights(3).requires_grad_(False)
    hg = model.Hourglass3D_0
    d, h, w = cfg.num_depth_planes, cfg.height // 4, cfg.width // 4
    rng = np.random.RandomState(9)
    vol = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    cut = lambda k: (slice(None), slice(shard.rank * k // shard.n,
                                        (shard.rank + 1) * k // shard.n))
    on = lambda sharded: shard if sharded else None
    pc = cfg.psv_channels
    _pair(res, "depth_stage_s1", lambda x, s: hg.ConvBnRelu2p1D_0(x, on(s)),
          vol(1, d, h, w, 2 * cfg.feature_channels), cut(d), cut(d))
    _pair(res, "depth_stage_s2", lambda x, s: hg.ConvBnRelu2p1D_1(x, on(s)),
          vol(1, d, h, w, pc), cut(d), cut(d // 2))
    _pair(res, "upsample_d", lambda x, s: resize_trilinear(
        x, ((d // 2 if s is None else d // 2 // shard.n), h // 2, w // 2),
        on(s)), vol(1, d // 4, h // 4, w // 4, 2 * pc), cut(d // 4),
        cut(d // 2))
    _pair(res, "score3d", lambda x, s: model.depth_score2(x, on(s)),
          vol(1, d, h, w, pc), cut(d), cut(d))
    planes = depth_planes(cfg.min_depth, cfg.max_depth, d)
    _pair(res, "soft_argmin", lambda x, s: soft_argmin_depth(
        x if s is None else V.gather_planes(x, shard), planes),
        vol(1, d, h, w), cut(d), None, replicated=True)
    calib = [torch.full((1,), v) for v in (180.0, 160.0, 48.0)]
    _pair(res, "psv_to_3dgv", lambda x, s: psv_to_3dgv(
        x, planes, *calib, cfg, cfg.feature_stride, on(s)),
        vol(1, d, h, w, cfg.gv_channels), cut(d), None, replicated=True)


def halo_calls():
    """The halo exchanges' calls since the traffic was reset: (forward,
    backward)."""
    return np.array([V.traffic[f"halo_exchange.{d}"]["calls"]
                     for d in ("fwd", "bwd")])


def dsgn_run(mesh, weights, res, tag, remat=False):
    """The tiny DSGN on `mesh`'s model axis: this rank's rows of the
    batch, its outputs, the loss over the whole batch and the rows' image
    gradients, as the PGD step computes them; with `remat` the hourglass
    is recomputed in the backward pass (cfg.remat)."""
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    cfg = tiny_cfg(remat)
    model = DSGN(cfg, volume_constraint=V.constrain_psv(mesh))
    model.load_state_dict(torch.load(weights, weights_only=True))
    model.requires_grad_(False)
    il, ir, calib, depth, boxes, nb = model_inputs()
    sharding = S.dp_sharding(mesh, BATCH)
    m255, s255 = torch.from_numpy(MEAN255), torch.from_numpy(STD255)
    with sharding:
        il, ir, calib, depth, boxes, nb = S.shard_batch(
            (il, ir, calib, depth, boxes, nb), sharding)
        vl, vr = (torch.from_numpy(a).requires_grad_(True) for a in (il, ir))
        V.reset_traffic()
        out = model((vl - m255) / s255, (vr - m255) / s255,
                    *(torch.from_numpy(c) for c in calib))
        total, parts = dsgn_total_loss(
            out, torch.from_numpy(depth), torch.from_numpy(boxes),
            torch.from_numpy(nb).long(), cfg)
        gl, gr = torch.autograd.grad(total, (vl, vr))
        res[tag + "loss"] = S.global_sum(total.detach()).numpy()
    for i, dp in enumerate(out["depth_preds"]):
        res[tag + f"depth{i}"] = dp.detach().numpy()
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        res[tag + k] = out[k].detach().numpy()
    res[tag + "grad_l"], res[tag + "grad_r"] = gl.numpy(), gr.numpy()
    res[tag + "rows"] = np.arange(BATCH)[sharding.rows]
    res[tag + "halo_calls"] = halo_calls()


def compat_run(mesh, weights, res, tag="compat_", remat=False):
    """The tiny compat model on `mesh`'s model axis, as `dsgn_run`."""
    from eval_driving_safety_tpu_torch.models import dsgn_compat as TC
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    cfg = tiny_cfg(remat)
    model = TC.DSGNCompat(cfg, TC.DSGNCompatArch.tiny(),
                          volume_constraint=V.constrain_psv(mesh))
    model.load_state_dict(torch.load(weights, weights_only=True))
    model.requires_grad_(False)
    il, ir, calib, depth, boxes, nb = compat_inputs()
    vl, vr = (torch.from_numpy(a).requires_grad_(True) for a in (il, ir))
    V.reset_traffic()
    out = model(vl, vr, *(torch.from_numpy(c) for c in calib))
    total, _ = dsgn_total_loss(out, torch.from_numpy(depth),
                               torch.from_numpy(boxes),
                               torch.from_numpy(nb.astype(np.int64)), cfg)
    gl, gr = torch.autograd.grad(total, (vl, vr))
    res[tag + "loss"] = total.detach().numpy()
    res[tag + "depth"] = out["depth_preds"][0].detach().numpy()
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        res[tag + k] = out[k].detach().numpy()
    res[tag + "grad_l"], res[tag + "grad_r"] = gl.numpy(), gr.numpy()
    res[tag + "halo_calls"] = halo_calls()


def main(out, weights_dir):
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    S.init_process_group("cpu")
    world = S.make_mesh().world
    res = {}
    primitives(S.make_mesh(1, world), res)
    if world == 2:
        mesh = S.make_mesh(1, 2)
        sharded_ops(mesh, res)
        for remat, r in ((False, ""), (True, "r")):
            dsgn_run(mesh, os.path.join(weights_dir, "dsgn.pt"), res,
                     f"m12{r}_", remat)
            compat_run(mesh, os.path.join(weights_dir, "compat.pt"), res,
                       f"compat{r}_", remat)
    else:
        mesh = S.make_mesh(2, 2)
        for remat, r in ((False, ""), (True, "r")):
            dsgn_run(mesh, os.path.join(weights_dir, "dsgn.pt"), res,
                     f"m22{r}_", remat)
    np.savez(out.replace("{rank}", str(mesh.rank)), **res)
    S.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
