"""The port's Stereo R-CNN predict slice against the JAX package on CPU:
the box solver, the dense alignment, the keypoint decode, the ingest,
the whole decode on the tiny model's outputs at batch 1 and 2, and the
predict CLI.

Tolerances: the solver is the same numpy f64 code on both sides, held
to 1e-9; the ingest is integer arithmetic and one f32 multiply, held
bit for bit, and so is the keypoint decode. The dense alignment's SSD is
summed in other orders (XLA's and torch's) and its candidates are
rounded from f64 where jnp.linspace rounds its own way, a last-bit
difference: disparities within 1e-5, success flags equal. Detections
from the tiny fp32 model (outputs within 1e-4 of each other, see
test_torch_stereo_rcnn.py): the same count and classes, boxes within
1e-4 px, location, rotation and score within 1e-4 relative.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.config import StereoRCNNConfig as JaxCfg
from eval_driving_safety_tpu.data import dataset as JD
from eval_driving_safety_tpu.data import kitti as JK
from eval_driving_safety_tpu.inference import stereo_rcnn_predict as JP
from eval_driving_safety_tpu.models.stereo_rcnn import StereoRCNN as JaxRCNN
from eval_driving_safety_tpu.ops import box_solver as JS
from eval_driving_safety_tpu.ops.dense_align import \
    align_disparities as jax_align
from eval_driving_safety_tpu_torch.cli.predict_and_save import main
from eval_driving_safety_tpu_torch.config import (SRCNNInputConfig,
                                                   StereoRCNNConfig)
from eval_driving_safety_tpu_torch.data import dataset as TD
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.inference import \
    stereo_rcnn_predict as TP
from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
from eval_driving_safety_tpu_torch.ops import box_solver as TS
from eval_driving_safety_tpu_torch.ops.dense_align import align_disparities
from eval_driving_safety_tpu_torch.utils.from_flax import \
    stereo_rcnn_state_dict_from_flax

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    worker processes, and torch's default of one thread per core in each
    of them oversubscribes the CPU many times over in the small ops of
    the tiny model's forward and backward."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CALIB = TK.Calibration.default()
# the tiny frames' calibration (a KITTI camera at 96 / 375 of its size)
TINY_CALIB = TK.Calibration.default(180.0, 160.0, 48.0)
MEANS = np.asarray((102.9801, 115.9465, 122.7717), np.float32)
SOLVER_TOL = dict(rtol=1e-9, atol=1e-9)


def _project(x, y, z, dims, theta):
    """A box's left and right 2D boxes, its keypoint column and corner."""
    c = TS._box_corners_cam(x, y, z, dims, theta)
    zs = np.maximum(c[:, 2], 0.5)
    us = CALIB.f_u * c[:, 0] / zs + CALIB.c_u
    vs = CALIB.f_u * c[:, 1] / zs + CALIB.c_v
    ur = CALIB.f_u * (c[:, 0] - CALIB.baseline) / zs + CALIB.c_u
    k = int(np.argmin(zs[:4]))
    return (np.array([us.min(), vs.min(), us.max(), vs.max()]),
            np.array([ur.min(), vs.min(), ur.max(), vs.max()]), us[k], k)


def _problems(n, seed, noise=0.0):
    """n seeded 3D boxes' 2D observations (boxes moved by `noise` px of
    Gaussian noise), half of them without a keypoint (u = -1)."""
    rng = np.random.RandomState(seed)
    dims = np.stack([1.4 + 0.3 * rng.rand(n), 1.5 + 0.4 * rng.rand(n),
                     3.5 + 1.0 * rng.rand(n)], 1)
    x, z = rng.uniform(-8, 8, n), rng.uniform(6, 40, n)
    y, th = rng.uniform(1.2, 1.9, n), rng.uniform(-np.pi, np.pi, n)
    alphas = th - np.arctan2(x, z)
    bl, br, kpts = [], [], []
    for i in range(n):
        l, r, u, k = _project(x[i], y[i], z[i], dims[i], th[i])
        bl.append(l + noise * rng.randn(4))
        br.append(r + noise * rng.randn(4))
        kpts.append([u if i % 2 == 0 else -1.0, k, 1.0, l[0], l[2]])
    return dict(alphas=alphas, dims=dims, bl=np.asarray(bl),
                br=np.asarray(br), kpts=np.asarray(kpts), x=x, z=z, th=th)


@pytest.mark.parametrize("noise", [0.0, 3.0])
def test_box_solver_matches_jax(noise):
    """The batched solvers, the initial state and infer_boundary on
    seeded problems, exact and with noisy boxes."""
    p = _problems(16, 7, noise)
    disp = CALIB.f_u * CALIB.baseline / p["z"]
    for i in range(0, 16, 3):
        args = (CALIB, p["alphas"][i], p["dims"][i], p["bl"][i])
        np.testing.assert_allclose(TS.initial_state(*args, p["br"][i]),
                                   JS.initial_state(*args, p["br"][i]),
                                   **SOLVER_TOL)
    batch = (CALIB, p["alphas"], p["dims"], p["bl"])
    ts, tst = TS.solve_batch_x_y_z_theta(*batch, p["br"], p["kpts"])
    js, jst = JS.solve_batch_x_y_z_theta(*batch, p["br"], p["kpts"])
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tst, jst, **SOLVER_TOL)
    for t, j in zip(TS.solve_batch_x_y_theta(*batch, disp, p["kpts"]),
                    JS.solve_batch_x_y_theta(*batch, disp, p["kpts"])):
        np.testing.assert_allclose(t, j, **SOLVER_TOL)
    # overlapping boxes, some occluding others
    rng = np.random.RandomState(3)
    x1, y1 = rng.uniform(0, 1000, 12), rng.uniform(100, 200, 12)
    boxes = np.stack([x1, y1, x1 + rng.uniform(50, 300, 12),
                      y1 + rng.uniform(30, 150, 12)], 1)
    got = TS.infer_boundary((375, 1242), boxes)
    np.testing.assert_array_equal(got, JS.infer_boundary((375, 1242),
                                                         boxes))
    assert (got != boxes[:, [0, 2]]).any()


def test_solver_recovers_gt_pose():
    gt = (2.0, 1.65, 15.0, 0.4)
    dims = np.array([1.5, 1.7, 4.0])
    box_l, box_r, kpt_u, kidx = _project(*gt[:3], dims, gt[3])
    alpha = gt[3] - math.atan2(gt[0], gt[2])
    kpts = np.array([[kpt_u, kidx, 1.0, box_l[0], box_l[2]]])
    status, state = TS.solve_batch_x_y_z_theta(
        CALIB, [alpha], dims[None], box_l[None], box_r[None], kpts)
    assert status[0] == 1
    np.testing.assert_allclose(state[0], gt, atol=0.3)
    st, z = TS.solve_batch_x_y_theta(
        CALIB, [alpha], dims[None], box_l[None],
        [CALIB.f_u * CALIB.baseline / gt[2]], kpts)
    np.testing.assert_allclose(z[0], gt[2], rtol=1e-9)
    np.testing.assert_allclose(st[0], [gt[0], gt[1], gt[3]], atol=0.3)
    init = TS.initial_state(CALIB, alpha, dims, box_l, box_r)
    assert 12.0 < init[2] < 18.0 and abs(init[0] - gt[0]) < 1.0


def test_infer_boundary_occlusion():
    boxes = np.array([[100.0, 50.0, 300.0, 150.0],    # occluded on its right
                      [250.0, 40.0, 400.0, 160.0]])   # in front
    ib = TS.infer_boundary((375, 1242), boxes)
    np.testing.assert_allclose(ib, [[100.0, 250.0], [250.0, 400.0]])


def test_batch_solver_matches_scalar_solver():
    """The port's batched solves take the JAX package's scalar solvers'
    iterations and stops, and recover the planted depths."""
    p = _problems(24, 5)
    disp = CALIB.f_u * CALIB.baseline / p["z"]
    batch = (CALIB, p["alphas"], p["dims"], p["bl"])
    status, states = TS.solve_batch_x_y_z_theta(*batch, p["br"], p["kpts"])
    fixed, zs = TS.solve_batch_x_y_theta(*batch, disp, p["kpts"])
    for i in range(24):
        args = ((375, 1242), CALIB, p["alphas"][i], p["dims"][i],
                p["bl"][i])
        s, st = JS.solve_x_y_z_theta_from_kpt(*args, p["br"][i],
                                              p["kpts"][i])
        assert s == status[i]
        if s > 0:
            np.testing.assert_allclose(states[i], st, rtol=1e-5, atol=1e-4)
        st3, z = JS.solve_x_y_theta_from_kpt(*args, disp[i], p["kpts"][i])
        np.testing.assert_allclose(zs[i], z, rtol=1e-12)
        np.testing.assert_allclose(fixed[i], st3, rtol=1e-5, atol=1e-4)
    ok = status > 0
    assert ok.sum() >= 22
    np.testing.assert_allclose(states[ok, 2], p["z"][ok], rtol=0.15)


def _smooth_image(rng, h, w):
    img = rng.rand(h, w, 3).astype(np.float32)
    return (img + np.roll(img, 1, 1) + np.roll(img, 1, 0)) / 3.0


def _shifted(left, d):
    """The right view of `left` at a disparity of d px (bilinear)."""
    w = left.shape[1]
    xs = np.arange(w) + d
    x0 = np.floor(xs).astype(int).clip(0, w - 1)
    x1 = (x0 + 1).clip(0, w - 1)
    f = (xs - np.floor(xs))[None, :, None]
    return (left[:, x0] * (1 - f) + left[:, x1] * f).astype(np.float32)


def test_dense_align_matches_jax():
    """Seeded boxes over a textured pair: inside, crossing the image's
    edges (penalized samples), degenerate and with too small an
    estimate (failures)."""
    rng = np.random.RandomState(1)
    left = _smooth_image(rng, 64, 256) * 255.0 - 110.0
    right = _shifted(left, 5.3)
    n = 14
    x1 = rng.uniform(-20, 220, n)
    y1 = rng.uniform(0, 40, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 80, n),
                      y1 + rng.uniform(1, 30, n)], 1).astype(np.float32)
    borders = (boxes[:, [0, 2]] + rng.uniform(-5, 5, (n, 2))).astype(
        np.float32)
    init = rng.uniform(0.2, 12.0, n).astype(np.float32)
    jok, jd = jax.jit(jax_align)(left, right, boxes, borders, init)
    tok, td = align_disparities(*(torch.from_numpy(a) for a in
                                  (left, right, boxes, borders, init)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < n
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-5)


def test_dense_align_recovers_shift():
    rng = np.random.RandomState(0)
    left = _smooth_image(rng, 64, 256)
    ok, disp = align_disparities(
        torch.from_numpy(left), torch.from_numpy(_shifted(left, 6.0)),
        torch.tensor([[60.0, 10.0, 140.0, 50.0]]),
        torch.tensor([[60.0, 140.0]]), torch.tensor([3.0]),
        num_candidates=97, sweep_px=6.0)
    assert bool(ok[0])
    np.testing.assert_allclose(float(disp[0]), 6.0, atol=0.15)


def test_decode_kpts_matches_jax_exactly():
    """Seeded probabilities with planted ties: the first bin wins on both
    sides."""
    rng = np.random.RandomState(4)
    r, g = 40, 28
    x1 = rng.uniform(0, 1000, r)
    boxes = np.stack([x1, rng.uniform(0, 100, r), x1 + rng.uniform(0, 300, r),
                      rng.uniform(100, 300, r)], 1).astype(np.float32)
    kp = rng.rand(r, 4 * g).astype(np.float32)
    lb, rb = rng.rand(r, g).astype(np.float32), rng.rand(r, g).astype(
        np.float32)
    for a in (kp, lb, rb):
        a[::3, 5] = a[::3, 9] = 2.0           # ties: bin 5 wins
    got = TP.decode_kpts(boxes, kp, lb, rb, g)
    np.testing.assert_array_equal(got, JP.decode_kpts(boxes, kp, lb, rb, g))
    assert (got[::3, 1] == 0).all()
    # a one-hot case: type 2, bin 5 of 10 over a 100-px box
    g = 10
    kp = np.zeros((1, 4 * g))
    kp[0, 2 * g + 5] = 1.0
    lb = np.zeros((1, g))
    lb[0, 0] = 1.0
    rb = np.zeros((1, g))
    rb[0, 9] = 1.0
    out = TP.decode_kpts(np.array([[100.0, 0.0, 199.0, 50.0]]), kp, lb, rb,
                         g)
    np.testing.assert_allclose(out[0], [155.0, 2, 1.0, 105.0, 195.0])


def _sample(fid, hw, seed):
    rng = np.random.RandomState(seed)
    left = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    return fid, left, np.roll(left, -5, axis=1)


def test_ingest_matches_jax_bit_for_bit():
    """Two frames of different sizes: the port's ingest on CPU tensors
    and JAX's device and host ingest give the same bits; the pixel
    conversion matches JAX's and inverts JAX's rgb01_to_srcnn."""
    cfg = SRCNNInputConfig(height=96, width=320)
    raw = [_sample("000001", (90, 300), 0), _sample("000002", (75, 200), 1)]
    tb = TD.prepare_srcnn_batch_u8(
        [TD.KittiSample(f, l, r, TINY_CALIB, [], l.shape[:2])
         for f, l, r in raw], cfg)
    jb = JD.prepare_srcnn_batch_u8(
        [JD.KittiSample(f, l, r, TINY_CALIB, [], l.shape[:2])
         for f, l, r in raw], JaxCfg.tiny().input)
    keys = ("ih", "iw", "den_h", "den_w", "wmask", "c")
    weights = {k: torch.from_numpy(tb[k]) for k in keys}
    jw = {k: jnp.asarray(jb[k]) for k in keys}
    jhost = JD.srcnn_clean01_host(jb)
    for side, jh in zip(("im_left_u8", "im_right_u8"), jhost):
        dev = TD.srcnn_clean01_device(weights, torch.from_numpy(tb[side]))
        jdev = jax.jit(JD.srcnn_clean01_device)(jw, jnp.asarray(jb[side]))
        assert dev.dtype == torch.float32
        for want in (np.asarray(jdev), jh):
            np.testing.assert_array_equal(dev.numpy(), want)
        assert dev[1, :, 256:].abs().max() == 0     # past the 2nd width
    lo, hi = TD.srcnn_clip_bounds(cfg)
    jlo, jhi = JD.srcnn_clip_bounds(JaxCfg.tiny().input)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    img01 = jhost[0][0][..., ::-1].copy()
    s = JK.rgb01_to_srcnn(img01, cfg.pixel_means_bgr)
    back = TK.srcnn_to_rgb01(s, cfg.pixel_means_bgr)
    np.testing.assert_array_equal(back, JK.srcnn_to_rgb01(
        s, cfg.pixel_means_bgr))
    np.testing.assert_allclose(back, img01, atol=1e-6)


def _tiny_pair(bsz):
    """Seeded textured frames at the tiny input size, the right view the
    left one 6 px on, as the model's input (BGR minus the means)."""
    cfg = JaxCfg.tiny()
    rng = np.random.RandomState(0)
    left = np.stack([_smooth_image(rng, cfg.input.height, cfg.input.width)
                     for _ in range(bsz)]) * 255.0
    right = np.stack([np.roll(f, -6, axis=1) for f in left])
    return (left - MEANS).astype(np.float32), \
        (right - MEANS).astype(np.float32)


@pytest.fixture(scope="module")
def planted_variables():
    """Tiny JAX weights with planted heads, so that boxes pass the score
    threshold and reach the solver and the dense alignment: the rcnn
    head's Car bias raised (its kernel scaled by 0.01, so the scores
    still differ between rois), zero box deltas but the right box's x
    shift (-0.2 of the width, a disparity that a car's width makes
    plausible), and the dimension-orientation head a constant car. The
    RPN's box conv is zeroed, so the proposals are the anchors
    themselves: the random RPN's deltas make boxes whose 3D solve is
    ill-conditioned, where the models' 1e-4 px differences move a pose
    by metres on both sides alike."""
    import flax
    cfg = JaxCfg.tiny()
    il, ir = _tiny_pair(1)
    v = flax.core.unfreeze(jax.jit(lambda k, a, b: JaxRCNN(cfg).init(
        k, a, b, mode="infer"))(jax.random.PRNGKey(1), il, ir))
    p = v["params"]
    rc = p["rcnn"]
    rc["cls_score"]["kernel"] = rc["cls_score"]["kernel"] * 0.01
    rc["cls_score"]["bias"] = jnp.asarray([0.0, 3.0])
    rc["bbox_pred"]["kernel"] = rc["bbox_pred"]["kernel"] * 0.0
    rc["bbox_pred"]["bias"] = jnp.asarray([0.0] * 10 + [-2.0, 0.0])
    rc["dim_orien_pred"]["kernel"] = rc["dim_orien_pred"]["kernel"] * 0.0
    rc["dim_orien_pred"]["bias"] = jnp.asarray(
        [0.0] * 5 + [1.5, 1.7, 4.0, 0.2, 0.98])
    p["rpn"]["rpn_box"]["kernel"] = p["rpn"]["rpn_box"]["kernel"] * 0.0
    return v


def _assert_same_detections(got, want):
    assert len(got) == len(want) > 0
    assert [d["type"] for d in got] == [d["type"] for d in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["dimensions"], w["dimensions"],
                                   rtol=1e-6)
        for k in ("location", "rotation_y", "score"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-12)


def _with_batch_column(host):
    """HostOutputs with the rois' batch column, as JAX's decode reads."""
    def col(r):
        return np.concatenate([np.zeros(r.shape[:-1] + (1,), r.dtype), r],
                              -1)
    return host._replace(rois_left=col(host.rois_left),
                         rois_right=col(host.rois_right))


@pytest.mark.parametrize("bsz", [1, 2])
def test_predict_matches_jax(planted_variables, bsz):
    """Each package's tiny model on the same frames and (bridged)
    weights, then each one's predict_image on every row of the batch at
    the scale of 90-row frames: the same detection dicts. The decoded
    outputs reach every stage: the kept boxes pass the solve and the
    alignment, whose successes alone are exported."""
    jcfg, tcfg = JaxCfg.tiny(), StereoRCNNConfig.tiny()
    il, ir = _tiny_pair(bsz)
    jout = jax.jit(lambda a, b: JaxRCNN(jcfg).apply(
        planted_variables, a, b, mode="infer"))(il, ir)
    model = StereoRCNN(tcfg)
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(
        planted_variables, model))
    with torch.no_grad():
        host = TP.fetch_outputs(model(torch.from_numpy(il),
                                      torch.from_numpy(ir), mode="infer"))
    scale = float(np.float32(96 / 90))
    n_solved = []
    for i in range(bsz):
        want = JP.predict_image(jout, il[i], ir[i], TINY_CALIB, jcfg,
                                image_hw=(90, 300), batch_index=i,
                                image_scale=scale)
        got = TP.predict_image(host, torch.from_numpy(il[i]),
                               torch.from_numpy(ir[i]), TINY_CALIB, tcfg,
                               image_hw=(90, 300), batch_index=i,
                               image_scale=scale)
        _assert_same_detections(got, want)
        n_solved.append(len(got))
        # the same host outputs through JAX's decode: the decode alone
        jhost = JP.predict_image(_with_batch_column(host), il[i], ir[i],
                                 TINY_CALIB, jcfg,
                                 image_hw=(90, 300), batch_index=i,
                                 image_scale=scale)
        _assert_same_detections(got, jhost)
    assert all(0 < n <= tcfg.max_detections for n in n_solved)


def test_fetch_outputs_packs_every_field():
    cfg = StereoRCNNConfig.tiny()
    model = StereoRCNN(cfg).init_weights(2).requires_grad_(False)
    il, ir = _tiny_pair(2)
    out = model(torch.from_numpy(il), torch.from_numpy(ir), mode="infer")
    host = TP.fetch_outputs(out)
    np.testing.assert_array_equal(host.rois_left,
                                  out.rois_left[..., 1:].numpy())
    np.testing.assert_array_equal(host.roi_valid, out.roi_valid.numpy())
    assert host.roi_valid.dtype == bool
    for name in TP.HostOutputs._fields[3:]:
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(out, name).numpy(), name)


def _planted_outputs(scale):
    """Model outputs planted for one car at (1, 1.6, 14) m, yaw 0.2, seen
    at `scale` x the original resolution (no dense alignment)."""
    r, g = 8, StereoRCNNConfig.tiny().kpts_grid
    gt = (1.0, 1.6, 14.0, 0.2)
    dims = (1.5, 1.7, 4.0)
    box_l, box_r, kpt_u, kidx = _project(*gt[:3], np.array(dims), gt[3])
    alpha = gt[3] - math.atan2(gt[0], gt[2])
    rois_l = np.zeros((1, r, 4), np.float32)
    rois_l[0] = box_l * scale
    rois_r = np.zeros((1, r, 4), np.float32)
    rois_r[0] = box_r * scale
    cls = np.zeros((1, r, 2), np.float32)
    cls[0, 0] = [0.05, 0.95]
    do = np.zeros((1, r, 10), np.float32)
    do[0, :, 5:] = [*dims, math.sin(alpha), math.cos(alpha)]
    kp = np.zeros((1, r, 4 * g), np.float32)
    kp[0, :, kidx * g + int((kpt_u - box_l[0]) / (box_l[2] - box_l[0] + 1)
                            * g)] = 1.0
    lb = np.zeros((1, r, g), np.float32)
    lb[0, :, 0] = 1.0
    rb = np.zeros((1, r, g), np.float32)
    rb[0, :, g - 1] = 1.0
    valid = np.eye(1, r, dtype=bool)
    return TP.HostOutputs(rois_l, rois_r, valid, cls,
                          np.zeros((1, r, 12), np.float32), do, kp, lb, rb), \
        gt, box_l


@pytest.mark.parametrize("scale", [1.0, 1.6])
def test_predict_image_recovers_a_planted_car(scale):
    """Planted outputs decode to one Car at the planted pose, exported at
    the original resolution: boxes at network scale (1.6 x) still solve
    against the original calibration."""
    cfg = dataclasses.replace(StereoRCNNConfig.tiny(),
                              input=SRCNNInputConfig(height=600, width=1984))
    outputs, gt, box_l = _planted_outputs(scale)
    dets = TP.predict_image(outputs, None, None, CALIB, cfg,
                            image_hw=(375, 1242), image_scale=scale)
    assert len(dets) == 1 and dets[0]["type"] == "Car"
    d = dets[0]
    assert d["score"] > 0.9
    np.testing.assert_allclose(d["location"][2], gt[2], atol=1.5)
    np.testing.assert_allclose(d["rotation_y"], gt[3], atol=0.3)
    np.testing.assert_allclose(d["bbox"], box_l, atol=2.0)


CLI_CALIB = ("P2: 180.0 0.0 160.0 11.2 0.0 180.0 48.0 0.05 0.0 0.0 1.0 "
             "0.003\nP3: 180.0 0.0 160.0 -86.0 0.0 180.0 48.0 0.05 0.0 0.0 "
             "1.0 0.003\n")
CLI_LABEL = ("Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 "
             "18.0 0.4\n")


def kitti_dir(root, ids, hw=(90, 300)):
    """Seeded textured KITTI-layout frames (the right view 5 px on)."""
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2"):
        os.makedirs(os.path.join(root, sub))
    for fid in ids:
        left = (_smooth_image(rng, *hw) * 255).astype(np.uint8)
        TK.write_png(os.path.join(root, "image_2", fid + ".png"), left)
        TK.write_png(os.path.join(root, "image_3", fid + ".png"),
                     np.roll(left, -5, axis=1))
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CLI_CALIB)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write(CLI_LABEL)


def planted_state_dict(variables):
    """The planted tiny weights as a state dict of the port's model."""
    model = StereoRCNN(StereoRCNNConfig.tiny())
    return stereo_rcnn_state_dict_from_flax(variables, model)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory, planted_variables):
    root = tmp_path_factory.mktemp("srcnn_predict")
    kitti_dir(str(root / "kitti"), ["000001", "000002"])
    torch.save(planted_state_dict(planted_variables), root / "w.pt")
    return root


def _predict(root, out, *extra):
    main(["--data_path", str(root / "kitti"), "--detector", "srcnn",
          "--tiny", "--device", "cpu", "--ckpt", str(root / "w.pt"),
          "--result_dir", str(out), *extra])


def test_cli_srcnn_writes_kitti_txts_and_the_same_bytes_twice(cli_data,
                                                              capsys):
    """One 16-field KITTI line per exported car, one txt per frame; the
    AP table; the input PNGs, the panels and the activations; a second
    run writes the same bytes."""
    a, b = cli_data / "a", cli_data / "b"
    _predict(cli_data, a, "--eval_ap", "--plot", "--save_input_dir",
             str(a / "inputs"), "--save_feat_dir", str(a / "feats"))
    out = capsys.readouterr().out
    assert "AP (Car, moderate, IoU 0.70)" in out
    assert os.path.exists(a / "metrics.jsonl")
    n_lines = 0
    for fid in ("000001", "000002"):
        lines = (a / "data" / f"{fid}.txt").read_text().splitlines()
        n_lines += len(lines)
        for line in lines:
            f = line.split()
            assert f[0] == "Car" and len(f) == 16
            assert all(math.isfinite(float(x)) for x in f[1:])
        assert (a / "refer" / f"{fid}.png").exists()
        img = TK.load_image_u8(str(a / "inputs" / "image_2" / f"{fid}.png"))
        assert img.shape == (96, 320, 3)
        assert len(os.listdir(a / "feats" / fid)) > 50
    assert n_lines > 0
    _predict(cli_data, b)
    for fid in ("000001", "000002"):
        rel = os.path.join("data", fid + ".txt")
        assert (a / rel).read_bytes() == (b / rel).read_bytes()
