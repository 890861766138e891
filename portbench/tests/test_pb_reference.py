"""The plain references compute what the port computes: at the tiny
configs in float32 on the CPU, the same loss and input gradients from
the same weights file and frames (the port's kernels run their plain
versions on the CPU), and the same gt and sampler draws built from the
traffic's files."""
import dataclasses
import json

import numpy as np
import torch

from portbench import frames, weights
from portbench.reference import dsgn as RD
from portbench.reference import srcnn as RS


def close(a, b, rtol=1e-5):
    return float((a - b).abs().max()) <= rtol * float(b.abs().max())


def test_dsgn_matches_the_port():
    from eval_driving_safety_tpu_torch.attack.objectives import total_loss
    from eval_driving_safety_tpu_torch.config import DSGNConfig, replace
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    c = replace(DSGNConfig.tiny(), dtype="float32")
    cfg = RD.config(json.loads(json.dumps(dataclasses.asdict(c))))
    ref = RD.DSGN(cfg)
    shapes = RD.init_shapes(ref)
    port = DSGN(c)
    assert set(port.state_dict()) == {n for n, _, _ in shapes}
    sd = weights.make_state_dict(shapes, 2 ** 31 + 7, "cpu")
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    port.requires_grad_(False)
    ref.requires_grad_(False)
    g = torch.Generator().manual_seed(0)
    il = torch.randint(0, 256, (2, 96, 320, 3), generator=g).float()
    ir = torch.roll(il, -5, 2)
    boxes = torch.zeros(2, 16, 8)
    boxes[:, 0] = torch.tensor([2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0])
    nb = torch.tensor([1, 1])
    loss, gl, gr = RD.attack_loss_and_grad(ref, cfg, il, ir, boxes, nb)
    mean = torch.tensor(c.input.mean) * 255
    std = torch.tensor(c.input.std) * 255
    xl, xr = il.clone().requires_grad_(True), ir.clone().requires_grad_(True)
    out = port((xl - mean) / std, (xr - mean) / std,
               *RD.calib_vectors(2, "cpu"))
    pl = total_loss(out, torch.zeros(2, 96, 320), boxes, nb, c)
    pgl, pgr = torch.autograd.grad(pl, (xl, xr))
    assert float(loss) == float(pl.detach())
    assert close(gl, pgl) and close(gr, pgr)


def test_srcnn_matches_the_port(tmp_path):
    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    from eval_driving_safety_tpu_torch.data.dataset import (
        KittiStereoDataset, prepare_srcnn_batch_u8, srcnn_cleanv_device)
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        StereoRCNN, make_gt_batch, total_attack_loss)
    c = StereoRCNNConfig.tiny()
    cfg = RS.config(json.loads(json.dumps(dataclasses.asdict(c))))
    ref = RS.StereoRCNN(cfg)
    shapes = RS.init_shapes(ref)
    port = StereoRCNN(c)
    assert set(port.state_dict()) == {n for n, _, _ in shapes}
    sd = weights.make_state_dict(shapes, 12345, "cpu")
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    port.requires_grad_(False)
    ref.requires_grad_(False)
    tr = frames.make_traffic(str(tmp_path), 77, dict(
        pairs=2, height=60, width=200, cars=[2, 3], split_ids=4,
        png_level=0))
    ds = KittiStereoDataset(tr.root, split_file=tr.split)
    b = prepare_srcnn_batch_u8([ds.get(0), ds.get(1)], c.input)
    gt = make_gt_batch(b["objects"], b["calibs"], c, image_scale=b["scales"])
    w = {k: torch.as_tensor(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                            "wmask")}
    vl = srcnn_cleanv_device(w, torch.as_tensor(b["im_left_u8"]))
    vr = srcnn_cleanv_device(w, torch.as_tensor(b["im_right_u8"]))
    draws = port.sample_draws(2, torch.Generator().manual_seed(11))
    c255 = torch.as_tensor(b["c255"])
    # the reference's own inputs, gt and draws equal the port's
    mine = np.stack([RS.clean_v(tr.left[tr.pair_of[i]], cfg)[0]
                     for i in tr.ids[:2]])
    assert np.array_equal(mine, vl.numpy())
    scales = [float(np.float32(cfg.input.height / 60))] * 2
    rgt = RS.gt_batch([tr.cars[tr.pair_of[i]] for i in tr.ids[:2]], scales,
                      cfg, "cpu")
    assert all(torch.equal(rgt[k], gt[k].to(rgt[k].dtype)) for k in gt)
    rd = ref.draws(2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(rd, draws))
    means = torch.tensor(c.input.pixel_means_bgr)
    xl, xr = vl.clone().requires_grad_(True), vr.clone().requires_grad_(True)
    cb = c255[:, None, None, None]
    out = port(xl * cb - means, xr * cb - means, gt=gt, draws=draws,
               mode="attack")
    pl = total_attack_loss(out.losses, torch.zeros(6))
    pgl, pgr = torch.autograd.grad(pl, (xl, xr))
    loss, gl, gr = RS.attack_loss_and_grad(ref, cfg, vl, vr, c255, rgt, rd,
                                           torch.zeros(6))
    assert float(loss) == float(pl.detach())
    assert close(gl, pgl) and close(gr, pgr)


def test_flop_counts_are_positive():
    from portbench import harness
    for name in ("dsgn_full.pgd_sweep", "srcnn_r101.pgd_sweep"):
        cell = harness.cell(name)
        ref = harness.reference_module(cell)
        assert ref.flops_per_unit(cell.config, cell.traffic, "attack") > 1e12
