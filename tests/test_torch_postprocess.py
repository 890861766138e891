"""The port's DSGN postprocessor against the JAX package on CPU: rotated
IoU, rotated NMS, the BEV decode, the KITTI writer, the AP evaluator and
the patch compositing, on the same seeded inputs.

Tolerances: rotated IoU 1e-6 absolute (both compute in float32, with
their own sin/cos and summation order); decoded boxes and scores 1e-6
relative, with an absolute floor of 1e-6 x the largest magnitude (the
BEV cell grids come from each framework's linspace, which may differ in
the last bit; the port's score map is float64 rounded to float32). Every
discrete result (kept indices, masks, classes, txt bytes, AP tables,
composited pixels) must be identical.
"""
import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.attack import patch as JP
from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.data import kitti as JK
from eval_driving_safety_tpu.evalap import kitti_ap as JAP
from eval_driving_safety_tpu.inference import fcos3d_post as JF
from eval_driving_safety_tpu.ops import nms as JN
from eval_driving_safety_tpu.ops import rotated as JR
from eval_driving_safety_tpu_torch.attack import patch as TP
from eval_driving_safety_tpu_torch.config import PLACEMENT_BANDS, DSGNConfig
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.evalap import kitti_ap as TAP
from eval_driving_safety_tpu_torch.inference import fcos3d_post as TF
from eval_driving_safety_tpu_torch.ops import nms as TN
from eval_driving_safety_tpu_torch.ops import rotated as TR


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _special_pairs():
    """(a, b) box5 pairs: identical, disjoint, contained, 45 degrees,
    touching along an edge, touching at a corner, a sliver."""
    s = np.sqrt(0.5)
    return np.array([
        [[0, 0, 2, 4, 0.3], [0, 0, 2, 4, 0.3]],              # identical
        [[0, 0, 2, 4, 0.0], [10, 10, 2, 4, 1.0]],            # disjoint
        [[0, 0, 4, 8, 0.2], [0.5, 0.2, 1, 2, 0.2]],          # contained
        [[0, 0, 4, 8, 0.0], [0.3, -0.1, 1, 1, 1.1]],         # rotated inside
        [[0, 0, 2, 2, 0.0], [0, 0, 2, 2, np.pi / 4]],        # 45 degrees
        [[0, 0, 2, 2, 0.0], [1 + s, 0, 2, 2, np.pi / 4]],    # 45, vertex
        [[0, 0, 2, 4, 0.0], [4, 0, 2, 4, 0.0]],              # edge contact
        [[0, 0, 2, 2, 0.0], [2, 2, 2, 2, 0.0]],              # corner contact
        [[0, 0, 2, 4, 0.0], [3.999, 0, 2, 4, 0.0]],          # sliver
        [[0, 0, 2, 4, 0.0], [0, 0, 2, 4, np.pi]],            # flipped
    ], np.float32)


def test_rotated_iou_special_pairs_match_jax():
    pairs = _special_pairs()
    a, b = pairs[:, 0], pairs[:, 1]
    want = np.asarray(JR.rotated_pairwise_iou(jnp.asarray(a),
                                              jnp.asarray(b)))
    got = TR.rotated_pairwise_iou(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    diag = np.diag(got)
    assert abs(diag[0] - 1) < 1e-6 and diag[1] == 0 and diag[7] == 0
    assert abs(diag[2] - 2 / 32) < 1e-6 and diag[6] < 1e-6


def test_rotated_iou_seeded_batched_matches_jax():
    """(B, N, M) batched against JAX's (N, M) per image."""
    rng = np.random.RandomState(0)
    b, n, m = 3, 17, 11

    def boxes(k):
        return np.concatenate([rng.uniform(-4, 4, (b, k, 2)),
                               rng.uniform(0.5, 4, (b, k, 2)),
                               rng.uniform(-np.pi, np.pi, (b, k, 1))],
                              -1).astype(np.float32)
    a, c = boxes(n), boxes(m)
    got = TR.rotated_pairwise_iou(_t(a), _t(c)).numpy()
    assert got.shape == (b, n, m)
    for i in range(b):
        want = np.asarray(JR.rotated_pairwise_iou(jnp.asarray(a[i]),
                                                  jnp.asarray(c[i])))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)
    assert (got > 0.05).sum() > 20                 # overlaps were exercised


def test_box5_corners_and_kitti_box5_match_jax():
    rng = np.random.RandomState(1)
    bx = rng.uniform(-3, 3, (20, 5)).astype(np.float32)
    np.testing.assert_allclose(TR.box5_to_corners(_t(bx)).numpy(),
                               np.asarray(JR.box5_to_corners(
                                   jnp.asarray(bx))), atol=1e-6)
    assert TR.kitti_bev_box5(1, 2, 3, 4, 0.5) == \
        JR.kitti_bev_box5(1, 2, 3, 4, 0.5)


def _clusters(seed, n_clusters=6, per=8):
    """Score clusters whose IoUs with each other straddle 0.3."""
    rng = np.random.RandomState(seed)
    boxes = []
    for _ in range(n_clusters):
        c = rng.uniform(-20, 20, 2)
        for _ in range(per):
            boxes.append([*(c + rng.uniform(-1.2, 1.2, 2)),
                          rng.uniform(1.5, 2.0), rng.uniform(3.5, 4.5),
                          rng.uniform(-0.6, 0.6)])
    boxes = np.asarray(boxes, np.float32)
    scores = rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32)
    scores[3] = scores[5]                          # an exact score tie
    valid = rng.rand(len(boxes)) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["fixpoint", "sequential"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_nms_matches_jax(seed, parallel):
    boxes, scores, valid = _clusters(seed)
    iou = np.asarray(JR.rotated_pairwise_iou(jnp.asarray(boxes),
                                             jnp.asarray(boxes)))
    off = ~np.eye(len(boxes), dtype=bool)
    # the clusters straddle the threshold; equal decisions need every IoU
    # to lie off it by more than the two IoUs' difference
    assert ((iou[off] > 0.2) & (iou[off] < 0.3)).any()
    assert ((iou[off] > 0.3) & (iou[off] < 0.45)).any()
    assert np.abs(iou - 0.3).min() > 1e-5
    want_i, want_m = JN.rotated_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    30, 0.3, valid=jnp.asarray(valid),
                                    parallel=parallel)
    got_i, got_m = TN.rotated_nms(_t(boxes)[None], _t(scores)[None], 30, 0.3,
                                  valid=_t(valid)[None], parallel=parallel)
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_m[0].numpy(), np.asarray(want_m))
    assert 0 < int(got_m.sum()) < int(valid.sum())   # some were suppressed


def test_rotated_nms_batch_rows_are_independent():
    rows = [_clusters(s) for s in (3, 4)]
    boxes, scores, valid = (torch.stack([_t(r[k]) for r in rows])
                            for k in range(3))
    bi, bm = TN.rotated_nms(boxes, scores, 20, 0.3, valid=valid)
    for k in range(2):
        i, m = TN.rotated_nms(boxes[k:k + 1], scores[k:k + 1], 20, 0.3,
                              valid=valid[k:k + 1])
        assert torch.equal(bi[k], i[0]) and torch.equal(bm[k], m[0])


def test_fixpoint_checks_convergence_every_few_steps():
    """A suppression chain of depth 12 converges in 12 steps; the loop
    reads one flag per CHECK_EVERY steps, not one per step."""
    n = 13
    boxes = np.stack([np.arange(n) * 0.9, np.zeros(n), np.full(n, 1.0),
                      np.full(n, 2.0), np.zeros(n)], -1).astype(np.float32)
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    before = TN.host_syncs["nms_fixpoint"]
    i, m = TN.rotated_nms(_t(boxes)[None], _t(scores)[None], n, 0.3)
    syncs = TN.host_syncs["nms_fixpoint"] - before
    want_i, want_m = JN.rotated_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    n, 0.3)
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(m[0].numpy(), np.asarray(want_m))
    assert int(m.sum()) == 7                        # every other box
    assert syncs <= -(-n // TN.CHECK_EVERY) + 1


@partial(jax.jit, static_argnums=(1, 2))
def _jax_kept_index(out, jcfg, k=256):
    """The JAX decode's flat map index of each kept detection (its
    top_k and rotated_nms, as decode_bev_outputs calls them)."""
    from eval_driving_safety_tpu.models.rpn3d_loss import bev_cell_centers
    zz, xx = bev_cell_centers(jcfg)
    smap = jax.nn.sigmoid(jnp.asarray(out["bbox_cls"])) * \
        jax.nn.sigmoid(jnp.asarray(out["bbox_centerness"]))[..., None]
    res = []
    for i in range(smap.shape[0]):
        top_s, top_i = jax.lax.top_k(smap[i].reshape(-1), k)
        cell = top_i // smap.shape[-1]
        rf = jnp.asarray(out["bbox_reg"])[i].reshape(-1, 8)[cell]
        ry = jnp.arctan2(rf[:, 6], rf[:, 7])
        bev5 = jnp.stack([xx.reshape(-1)[cell] + rf[:, 0],
                          zz.reshape(-1)[cell] + rf[:, 1],
                          jnp.exp(rf[:, 4]), jnp.exp(rf[:, 5]), -ry], -1)
        keep, _ = JN.rotated_nms(bev5, top_s, jcfg.max_detections,
                                 jcfg.nms_thresh,
                                 valid=top_s > jcfg.score_thresh)
        res.append(top_i[keep])
    return jnp.stack(res)


def _bev_maps(seed, cfg, ties):
    rng = np.random.RandomState(seed)
    b, z, x, c = 2, cfg.num_voxels_z, cfg.num_voxels_x, cfg.num_classes
    if ties:
        # logits on a coarse grid (as the bf16 head's are): many exact ties
        cls = rng.randint(-10, 1, (b, z, x, c)) * 0.5
        ctr = rng.randint(-2, 3, (b, z, x)) * 0.5
    else:
        cls = rng.normal(-3.0, 1.5, (b, z, x, c))
        ctr = rng.normal(0.0, 1.0, (b, z, x))
    # boxes of 2-4 m on the 1.6 m grid: neighbours overlap, NMS suppresses
    reg = np.concatenate([rng.normal(0, 0.5, (b, z, x, 3)),
                          rng.normal(1.0, 0.2, (b, z, x, 3)),
                          rng.normal(0, 1, (b, z, x, 2))], -1)
    f = lambda a: a.astype(np.float32)
    return {"bbox_cls": f(cls), "bbox_reg": f(reg),
            "bbox_centerness": f(ctr)}


@pytest.mark.parametrize("classes", [1, 2])
@pytest.mark.parametrize("ties", [True, False], ids=["ties", "continuous"])
def test_decode_matches_jax(ties, classes):
    # a threshold that drops some of the kept boxes
    tcfg = dataclasses.replace(DSGNConfig.tiny(), num_classes=classes,
                               score_thresh=0.33)
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), num_classes=classes,
                               score_thresh=0.33)
    out = _bev_maps(7 + classes, tcfg, ties)
    if ties:
        flat = out["bbox_cls"].reshape(2, -1)
        assert len(np.unique(flat[0])) < 16       # the top-k crosses ties
    want = jax.jit(JF.decode_bev_outputs, static_argnums=1)(
        {k: jnp.asarray(v) for k, v in out.items()}, jcfg)
    got = TF.fetch_detections(TF.decode_bev_outputs(
        {k: _t(v) for k, v in out.items()}, tcfg))
    np.testing.assert_array_equal(
        got.index, np.asarray(_jax_kept_index(
            {k: jnp.asarray(v) for k, v in out.items()}, jcfg)))
    np.testing.assert_array_equal(got.classes, np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    assert 0 < got.valid.sum() < got.valid.size
    for g, w in ((got.boxes3d, want.boxes3d), (got.scores, want.scores)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


def _host_dets(seed, k=12):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(-10, 10, (1, k, 1)), rng.uniform(1.0, 2.0, (1, k, 1)),
        rng.uniform(4, 40, (1, k, 1)), rng.uniform(1.3, 1.9, (1, k, 1)),
        rng.uniform(1.4, 2.0, (1, k, 1)), rng.uniform(3, 5, (1, k, 1)),
        rng.uniform(-np.pi, np.pi, (1, k, 1))], -1).astype(np.float32)
    boxes[0, 3, 2] = -5.0                  # behind the camera: clipped away
    boxes[0, 4, 0] = 80.0                  # off the image's side
    scores = rng.uniform(0, 1, (1, k)).astype(np.float32)
    classes = rng.randint(0, 3, (1, k))
    valid = rng.rand(1, k) > 0.2
    return boxes, scores, classes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_export_bytes_match_jax(tmp_path, seed):
    boxes, scores, classes, valid = _host_dets(seed)
    calib = TK.Calibration.default()
    jcalib = JK.Calibration.default()
    names = ("Car", "Pedestrian", "Cyclist")
    want = JF.detections_to_kitti(
        JF.Detections3D(boxes[0], scores[0], classes[0], valid[0]), jcalib,
        (375, 1242), names)
    got = TF.detections_to_kitti(
        TF.Detections3D(boxes[0], scores[0], classes[0], valid[0], None),
        calib, (375, 1242), names)
    assert 0 < len(got) < valid.sum()
    JK.write_detections(str(tmp_path / "jax" / "000001.txt"), want)
    TK.write_detections(str(tmp_path / "port" / "000001.txt"), got)
    a = (tmp_path / "jax" / "000001.txt").read_bytes()
    assert a == (tmp_path / "port" / "000001.txt").read_bytes()
    assert all(len(ln.split(" ")) == 16 for ln in a.decode().splitlines())


def test_kitti_object_lines_round_trip_as_jax():
    line = "Car 0.12 1 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 " \
           "-0.65 1.71 46.70 -1.59 0.87654321"
    t, j = TK.KittiObject.from_line(line), JK.KittiObject.from_line(line)
    assert t.to_line() == j.to_line() == line
    calib = TK.Calibration.default()
    assert calib.f_v == JK.Calibration.default().f_v == calib.P2[1, 1]


def _label_folders(root, seed, n_images=6):
    """Seeded gt and detection folders: detections are jittered gts (some
    over, some under the 0.7 / 0.5 gates), misses and false positives."""
    rng = np.random.RandomState(seed)
    gt_dir, det_dir = root / "gt", root / "det"
    gt_dir.mkdir(), det_dir.mkdir()
    classes = ("Car", "Pedestrian", "Van", "DontCare")
    for i in range(n_images):
        gts, dets = [], []
        for _ in range(rng.randint(2, 5)):
            cls = classes[rng.randint(len(classes))]
            x, z = rng.uniform(-10, 10), rng.uniform(5, 30)
            h, w, l = rng.uniform(1.4, 1.8), rng.uniform(1.5, 1.9), \
                rng.uniform(3.4, 4.4)
            ry = rng.uniform(-np.pi, np.pi)
            u = 600 + 700 * x / z
            bh = 700 * h / z
            bbox = np.array([u - 60 * w * 10 / z, 180 - bh / 2,
                             u + 60 * w * 10 / z, 180 + bh / 2])
            g = JK.KittiObject(cls, float(rng.choice([0.0, 0.2, 0.4])),
                               float(rng.randint(0, 3)),
                               -np.arctan2(x, z) + ry, bbox,
                               np.array([h, w, l]),
                               np.array([x, 1.6, z]), ry)
            gts.append(g)
            if cls == "DontCare" or rng.rand() < 0.2:
                continue
            j = rng.uniform(0.0, 0.3)
            dets.append(JK.KittiObject(
                "Car" if cls == "Van" else cls, 0.0, 0.0,
                g.alpha + rng.normal(0, 0.2), bbox + rng.normal(0, 8 * j, 4),
                g.dimensions * (1 + rng.normal(0, 0.1 * j, 3)),
                g.location + np.array([rng.normal(0, j), rng.normal(0, 0.1),
                                       rng.normal(0, 2 * j)]),
                ry + rng.normal(0, 0.3 * j), float(rng.uniform(0.05, 1.0))))
        for _ in range(rng.randint(0, 2)):                  # false positives
            x, z = rng.uniform(-15, 15), rng.uniform(5, 50)
            dets.append(JK.KittiObject(
                "Car", 0.0, 0.0, 0.1, np.array([100., 150., 180., 220.]),
                np.array([1.5, 1.6, 3.9]), np.array([x, 1.6, z]), 0.2,
                float(rng.uniform(0.05, 0.6))))
        JK.write_label(str(gt_dir / f"{i:06d}.txt"), gts)
        if i % 5 != 4:                                      # a missing file
            JK.write_label(str(det_dir / f"{i:06d}.txt"), dets)
    return str(gt_dir), str(det_dir)


@pytest.mark.parametrize("seed,classes", [(0, ("Car", "Pedestrian")),
                                          (1, ("Car",))])
def test_ap_tables_match_jax(tmp_path, seed, classes):
    gt_dir, det_dir = _label_folders(tmp_path, seed)
    want = JAP.evaluate_folders_full(gt_dir, det_dir, classes)
    got = TAP.evaluate_folders_full(gt_dir, det_dir, classes)
    assert got == want
    assert TAP.format_ap_table(got) == JAP.format_ap_table(want)
    aps = [v for per in got.values() for r in per.values() for v in r.values()]
    assert any(0 < a < 1 for a in aps)             # a non-trivial table


def test_bev_iou_of_the_evaluator_is_float32_as_jax(tmp_path):
    gt_dir, det_dir = _label_folders(tmp_path, 3, n_images=3)
    gts, dets = TAP._load_folders(gt_dir, det_dir)
    for g, d in zip(gts, dets):
        got = TAP._iou_bev(g, d)
        want = JAP._iou_bev(g, d)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# centres (row, col) on a 40 x 64 image with a 9-pixel patch (r = 4):
# inside, clipped by each border, 2r-clipped corners, fully off-image
CENTERS = [(20, 30), (0, 30), (-3, 10), (39, 63), (42, 66), (20, -4),
           (20, 67), (-4, -4), (43, 67), (-5, 30), (20, 68), (-9, -9),
           (100, 10)]


@pytest.mark.parametrize("center", CENTERS, ids=str)
def test_composite_matches_jax(center):
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 1, (40, 64, 3)).astype(np.float32)
    patch = rng.uniform(0, 1, (9, 9, 3)).astype(np.float32)
    want = np.asarray(JP.composite_patch(jnp.asarray(img),
                                         jnp.asarray(patch),
                                         jnp.asarray(center)))
    got = TP.composite_patch(_t(img), _t(patch), center).numpy()
    np.testing.assert_array_equal(got, want)
    # the pixels that changed are the image's pixels inside the circle
    yy, xx = np.mgrid[:40, :64]
    inside = (yy - center[0]) ** 2 + (xx - center[1]) ** 2 <= 16
    np.testing.assert_array_equal((got != img).any(-1), inside)


def test_composite_batch_and_sampled_centres_in_their_bands(tmp_path):
    rng = np.random.RandomState(1)
    b, h, w = 64, 48, 160
    imgs = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    d = TP.patch_dim_for(h, 0.35)
    assert d == JP.patch_dim_for(h, 0.35) and d % 2 == 1
    patch = rng.uniform(0, 1, (d, d, 3)).astype(np.float32)
    TP.save_patch(str(tmp_path / "p.npy"), _t(patch))
    assert np.load(tmp_path / "p.npy").shape == (1, 3, d, d)
    np.testing.assert_array_equal(
        np.asarray(JP.load_patch(str(tmp_path / "p.npy"))),
        TP.load_patch(str(tmp_path / "p.npy")).numpy())
    r = d // 2
    for mode, (lo, hi) in PLACEMENT_BANDS.items():
        cl, cr = TP.sample_patch_centers(torch.Generator().manual_seed(0), b,
                                         h, w, r, col_band=(lo, hi))
        rows, cols = cl[:, 0].numpy(), cl[:, 1].numpy()
        assert rows.min() >= int(h * 0.4) and rows.max() <= h - r - 1, mode
        assert cols.min() >= int(w * lo) and cols.max() <= int(w * hi), mode
        assert np.array_equal(cr[:, 0], cl[:, 0])
        assert np.array_equal(cr[:, 1], cl[:, 1] - 64)
        got = TP.composite_patch_batch(_t(imgs), _t(patch), cr).numpy()
        want = np.asarray(JP.composite_patch_batch(
            jnp.asarray(imgs), jnp.asarray(patch), jnp.asarray(cr.numpy())))
        np.testing.assert_array_equal(got, want)
    # a patch of another size is resized as the JAX package resizes it
    np.testing.assert_allclose(
        TP.load_patch(str(tmp_path / "p.npy"), resize_to=d + 2).numpy(),
        np.asarray(JP.load_patch(str(tmp_path / "p.npy"), resize_to=d + 2)),
        rtol=0, atol=1e-5)


def test_depth_export_matches_jax(tmp_path):
    from eval_driving_safety_tpu.inference import depth_export as JD
    from eval_driving_safety_tpu_torch.inference import depth_export as TD
    rng = np.random.RandomState(2)
    depth = rng.uniform(0.1, 90.0, (24, 40)).astype(np.float32)
    calib = TK.Calibration.default()
    jcalib = JK.Calibration.default()
    for stride in (1, 4):
        np.testing.assert_array_equal(
            TD.depth_to_points(depth, calib, stride=stride),
            JD.depth_to_points(depth, jcalib, stride=stride))
    np.testing.assert_array_equal(TD.disparity_to_depth(depth, calib),
                                  JD.disparity_to_depth(depth, jcalib))
    np.testing.assert_array_equal(TD.depth_to_disparity(depth, calib),
                                  JD.depth_to_disparity(depth, jcalib))
    TD.save_pseudo_lidar(str(tmp_path / "t" / "a.bin"), depth, calib)
    JD.save_pseudo_lidar(str(tmp_path / "j" / "a.bin"), depth, jcalib)
    TD.save_depth_map(str(tmp_path / "t" / "a.npy"), depth)
    JD.save_depth_map(str(tmp_path / "j" / "a.npy"), depth)
    for name in ("a.bin", "a.npy"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    assert os.path.getsize(tmp_path / "t" / "a.bin") > 0
