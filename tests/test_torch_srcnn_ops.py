"""The Stereo R-CNN ops of the port against the JAX package on CPU: boxes,
anchors, axis-aligned NMS, ROIAlign and its VJP, the exact integer
resize, the v-space replay, the Stereo R-CNN batch and its gt, and the
three target layers with injected draws.

Tolerances: integer results, indices, labels and masks are equal; the
box ops, anchors and the v-space arithmetic are held bit for bit where
both sides do the same f32 operations, and within 1e-6 of the largest
magnitude where an exp or a log (each library's own) is in the chain;
ROIAlign and
its VJP within 1e-5 of the largest magnitude (f32 sums in other
orders); targets within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from eval_driving_safety_tpu.attack import pgd as jpgd
from eval_driving_safety_tpu.config import StereoRCNNConfig as JaxCfg
from eval_driving_safety_tpu.data import dataset as jds
from eval_driving_safety_tpu.data import exact_resize as jer
from eval_driving_safety_tpu.data import kitti as jkitti
from eval_driving_safety_tpu.models import stereo_rcnn as jsr
from eval_driving_safety_tpu.models import stereo_targets as jst
from eval_driving_safety_tpu.ops import anchors as janc
from eval_driving_safety_tpu.ops import boxes as jb
from eval_driving_safety_tpu.ops import nms as jnms
from eval_driving_safety_tpu.ops import roi_align as jra
from eval_driving_safety_tpu_torch.attack import pgd as tpgd
from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.data import dataset as tds
from eval_driving_safety_tpu_torch.data import exact_resize as ter
from eval_driving_safety_tpu_torch.data import kitti as tkitti
from eval_driving_safety_tpu_torch.models import stereo_rcnn as tsr
from eval_driving_safety_tpu_torch.models import stereo_targets as tst
from eval_driving_safety_tpu_torch.ops import anchors as tanc
from eval_driving_safety_tpu_torch.ops import boxes as tb
from eval_driving_safety_tpu_torch.ops import nms as tnms
from eval_driving_safety_tpu_torch.ops import roi_align as tra

T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _boxes(rng, n, w=320.0, h=96.0):
    x1 = rng.uniform(-10, w, n)
    y1 = rng.uniform(-10, h, n)
    return np.stack([x1, y1, x1 + rng.uniform(2, 120, n),
                     y1 + rng.uniform(2, 60, n)], -1).astype(np.float32)


def _exp_log_close(got, want):
    """Within 1e-6 of the largest magnitude: an f32 exp or log of another
    library differs in its last bit, and the box arithmetic after it
    (centre minus half a large width) can cancel most of the leading
    digits."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 40)
    d6 = rng.normal(0, 0.5, (40, 6)).astype(np.float32)
    d6[:3, 2] = [-12.0, 5.0, 4.0]                    # the clip's edges
    exact = [
        (tb.pairwise_iou(T(a), T(b)), jb.pairwise_iou(a, b)),
        (tb.pairwise_iou(T(np.stack([a, b])), T(np.stack([b, a])))[1],
         jb.pairwise_iou(b, a)),
        (tb.box_area(T(a)), jb.box_area(a)),
        (tb.clip_boxes(T(a), 96, 320), jb.clip_boxes(a, 96, 320)),
        (tb.union_boxes(T(a), T(b)), jb.union_boxes(a, b)),
        (tb.smooth_l1(T(d6), 3.0), jb.smooth_l1(d6, 3.0))]
    for got, want in exact:
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    # exp and log are other libraries' on the two sides
    _exp_log_close(tb.encode_boxes(T(a), T(b)), jb.encode_boxes(a, b))
    _exp_log_close(tb.encode_stereo_boxes(T(a), T(b), T(b[::-1].copy())),
               jb.encode_stereo_boxes(a, b, b[::-1]))
    _exp_log_close(tb.decode_boxes(T(a), T(d6[:, :4].copy())),
               jb.decode_boxes(a, d6[:, :4]))
    for got, want in zip(tb.decode_stereo_boxes(T(a), T(d6)),
                         jb.decode_stereo_boxes(a, d6)):
        _exp_log_close(got, want)


@pytest.mark.parametrize("hw", [(96, 320), (600, 1984)])
def test_anchors_match_jax(hw):
    cfg = StereoRCNNConfig()
    shapes = tanc.fpn_feat_shapes(*hw, cfg.feat_strides)
    assert shapes == janc.fpn_feat_shapes(*hw, cfg.feat_strides)
    args = (shapes, tuple(cfg.feat_strides), tuple(cfg.anchor_scales),
            tuple(cfg.anchor_ratios))
    got = tanc.pyramid_anchors(*args)
    np.testing.assert_array_equal(got, janc.pyramid_anchors(*args))
    if hw == (600, 1984):
        assert got.shape == (297600, 4)


def _nms_case(seed, n=60):
    rng = np.random.RandomState(seed)
    centres = _boxes(rng, 6)
    boxes = np.repeat(centres, n // 6, 0) + rng.normal(
        0, 6, (n, 4)).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[5] = scores[7]                          # an exact tie
    valid = rng.rand(n) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_and_nms_parallel_match_jax(seed):
    boxes, scores, valid = _nms_case(seed)
    for tfn, jfn in ((tnms.nms, jnms.nms),
                     (tnms.nms_parallel, jnms.nms_parallel)):
        idx, ok = tfn(T(boxes)[None], T(scores)[None], 20, 0.5,
                      valid=T(valid)[None])
        jidx, jok = jfn(boxes, scores, 20, 0.5, valid=valid)
        np.testing.assert_array_equal(_np(ok[0]), np.asarray(jok))
        np.testing.assert_array_equal(_np(idx[0])[_np(ok[0])],
                                      np.asarray(jidx)[np.asarray(jok)])


def _roi_case(seed, b=2, h=13, w=29, c=5, n=9, stride=4):
    rng = np.random.RandomState(seed)
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    bx = _boxes(rng, n, w * stride, h * stride)
    bx[0] = [-30.0, -20.0, 8.0, 6.0]              # partly off the map
    bx[1] = [w * stride - 5, 10.0, w * stride + 40, 30.0]
    rois = np.concatenate([rng.randint(0, b, (n, 1)), bx], 1)
    return feat, rois.astype(np.float32)


@pytest.mark.parametrize("size,ratio", [(7, 2), (14, 2), (3, 3)])
def test_roi_align_and_vjp_match_jax(size, ratio):
    feat, rois = _roi_case(size)
    fn = lambda f, r: jra.roi_align(f, r, size, 0.25, ratio)   # noqa: E731
    want, vjp = jax.vjp(fn, feat, rois)
    ct = np.random.RandomState(1).normal(size=want.shape).astype(np.float32)
    jf, jr = vjp(ct)
    f = T(feat).requires_grad_(True)
    r = T(rois).requires_grad_(True)
    got = tra.roi_align(f, r, size, 0.25, ratio)
    gf, gr = torch.autograd.grad(got, (f, r), T(ct), allow_unused=True)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(_np(gf), jf, rtol=0,
                               atol=1e-5 * float(np.abs(jf).max()))
    # the roi coordinates get no gradient, on either side
    assert gr is None and not np.any(np.asarray(jr))


def test_pyramid_roi_align_and_levels_match_jax():
    rng = np.random.RandomState(3)
    feats = [rng.normal(size=(1, 96 // s, 320 // s, 4)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    x1 = rng.uniform(0, 200, 24)
    y1 = rng.uniform(0, 60, 24)
    sz = np.exp(rng.uniform(np.log(4), np.log(900), 24))
    rois = np.stack([np.zeros(24), x1, y1, x1 + sz, y1 + sz * 0.5],
                    -1).astype(np.float32)
    np.testing.assert_array_equal(_np(tra.roi_levels(T(rois))),
                                  np.asarray(jra.roi_levels(rois)))
    assert len(set(np.asarray(jra.roi_levels(rois)).tolist())) == 4
    want, vjp = jax.vjp(lambda *f: jra.pyramid_roi_align(f, rois, 7),
                        *feats)
    ct = rng.normal(size=want.shape).astype(np.float32)
    tf = [T(f).requires_grad_(True) for f in feats]
    got = tra.pyramid_roi_align(tf, T(rois), 7)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    for g, jg in zip(torch.autograd.grad(got, tf, T(ct)), vjp(ct)):
        np.testing.assert_allclose(_np(g), jg, rtol=0,
                                   atol=1e-5 * float(np.abs(jg).max()))


def _frame(rng, hw):
    return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)


@pytest.mark.parametrize("sizes", [((375, 1242), (600, 1987)),
                                   ((90, 300), (96, 320)),
                                   ((7, 11), (5, 17))])
def test_exact_resize_host_and_device_match_jax(sizes):
    (ih, iw), (oh, ow) = sizes
    rng = np.random.RandomState(ih)
    img = _frame(rng, (ih, iw))
    crop = min(ow, 1984)
    wh, ww = ter.bilinear_axis_weights(ih, oh), \
        ter.bilinear_axis_weights(iw, ow, crop=crop)
    jwh, jww = jer.bilinear_axis_weights(ih, oh), \
        jer.bilinear_axis_weights(iw, ow, crop=crop)
    for a, b in zip(wh + ww, jwh + jww):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    host = ter.resize_v2_host(img, wh, ww)
    np.testing.assert_array_equal(host, jer.resize_v2_host(img, jwh, jww))
    # the device half on a padded batch of two frames, per-sample weights
    pad = np.zeros((2, ih + 5, iw + 3, 3), np.uint8)
    pad[0, :ih, :iw] = img
    pad[1, :ih, :iw] = img[::-1]
    w = [np.stack([x] * 2) for x in (wh.i0, wh.i1, wh.r)] + \
        [np.array([wh.den] * 2, np.int32)] + \
        [np.stack([x] * 2) for x in (ww.i0, ww.i1, ww.r)] + \
        [np.array([ww.den] * 2, np.int32)]
    dev = ter.resize_v2_device(T(pad), *[T(x) for x in w])
    jdev = jer.resize_v2_device(jnp.asarray(pad), *[jnp.asarray(x)
                                                    for x in w])
    np.testing.assert_array_equal(_np(dev), np.asarray(jdev))
    np.testing.assert_array_equal(_np(dev)[0], host)
    np.testing.assert_array_equal(_np(dev)[1],
                                  ter.resize_v2_host(img[::-1], wh, ww))


def _batches(hws=((375, 1242), (370, 1224))):
    """The same two frames as a JAX and a port KittiSample list."""
    rng = np.random.RandomState(5)
    objs = [l for l in chip_smoke.LABELS.splitlines() if l]
    frames = [(f"00000{i}", _frame(rng, hw), _frame(rng, hw))
              for i, hw in enumerate(hws)]
    out = []
    for kitti, ds in ((jkitti, jds), (tkitti, tds)):
        calib = kitti.Calibration(
            P2=np.array(chip_smoke.CALIB.split("\n")[0].split()[1:],
                        float).reshape(3, 4),
            P3=np.array(chip_smoke.CALIB.split("\n")[1].split()[1:],
                        float).reshape(3, 4))
        out.append([ds.KittiSample(fid, l, r, calib,
                                   [kitti.KittiObject.from_line(o)
                                    for o in objs], l.shape[:2])
                    for fid, l, r in frames])
    return out


def test_srcnn_batch_cleanv_and_quantize_match_jax():
    jsam, tsam = _batches()
    jb_ = jds.prepare_srcnn_batch_u8(jsam)
    tb_ = tds.prepare_srcnn_batch_u8(tsam)
    for k, v in jb_.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tb_[k], v, err_msg=k)
    assert tb_["net_hw"] == jb_["net_hw"] == [(600, 1984)] * 2
    # paper scale: K = 16 * 3974 for a 375 x 1242 frame
    assert int(tb_["den_h"][0]) * int(tb_["den_w"][0]) == 63584
    jv = jds.srcnn_cleanv_host(jb_)
    tv = tds.srcnn_cleanv_host(tb_)
    weights = {k: T(tb_[k]) for k in ("ih", "iw", "den_h", "den_w",
                                      "wmask")}
    for side, key in enumerate(("im_left_u8", "im_right_u8")):
        np.testing.assert_array_equal(tv[side], jv[side])
        dev = tds.srcnn_cleanv_device(weights, T(tb_[key]))
        np.testing.assert_array_equal(_np(dev), tv[side].astype(np.float32))
        q = tds.quantize_v_batch_u8(tv[side], tb_["c255"])
        np.testing.assert_array_equal(
            q, jds.quantize_v_batch_u8(jv[side], jb_["c255"]))
        # the tensor path (the card's --transfer full) equals the host's
        np.testing.assert_array_equal(
            _np(tds.quantize_v_rgb_u8(dev[None], T(tb_["c255"])))[0], q)
    q0 = tds.srcnn_cleanv_q0_host(tb_)
    for got, want in zip(q0, jds.srcnn_cleanv_q0_host(jb_)):
        np.testing.assert_array_equal(got, want)


def test_make_gt_batch_matches_jax_on_chip_smoke_labels():
    jsam, tsam = _batches()
    jcfg, tcfg = JaxCfg(), StereoRCNNConfig()
    scales = np.array([1.6, 600 / 370], np.float32)
    want = jsr.make_gt_batch([s.objects for s in jsam],
                             [s.calib for s in jsam], jcfg, scales)
    got = tsr.make_gt_batch([s.objects for s in tsam],
                            [s.calib for s in tsam], tcfg, scales)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert _np(got["num_boxes"]).tolist() == [2, 2]


@pytest.mark.parametrize("a_pix,e_pix,K", [
    (1.0, 76.5, [63584]), (1.0, 76.5, [63584, 48000]),
    (0.5, 76.5, [63584]), (1.0, 76.5, [70000]), (0.3, 8.0, [100]),
    (2.0, 300.0, [60000])])
def test_srcnn_replay_intable_matches_jax(a_pix, e_pix, K):
    assert tpgd.srcnn_replay_intable(a_pix, e_pix, np.asarray(K)) == \
        jpgd.srcnn_replay_intable(a_pix, e_pix, np.asarray(K))


def test_replay_pgd_ints_matches_jax_and_the_f32_chain():
    """Both replays of packed signs at the paper's K, doubled ints equal
    to each other and, halved, to the f32 update chain."""
    rng = np.random.RandomState(7)
    K = np.array([63584.0, 48000.0])
    clean = (rng.randint(0, 256, (2, 4, 16, 3)) * K.reshape(-1, 1, 1, 1)
             * (rng.rand(2, 4, 16, 3) < 0.7)).astype(np.int32)
    packed = rng.randint(0, 256, (3, 2, 4, 12)).astype(np.uint8)
    packed[..., 0] = 0b01010101                    # zero signs too
    kw = dict(alpha2=2 * K, eps2=2 * 76.5 * K, clip_max2=510 * K)
    got = list(tpgd.replay_pgd_ints(2 * clean, 2 * clean[::-1], packed,
                                    packed[::-1], **kw))
    want = list(jpgd.replay_pgd_ints(2 * clean, 2 * clean[::-1], packed,
                                     packed[::-1], **kw))
    f32 = list(tpgd.replay_pgd(
        clean.astype(np.float32), clean[::-1].astype(np.float32), packed,
        packed[::-1], alpha=K.reshape(-1, 1, 1, 1).astype(np.float32),
        eps=(76.5 * K).reshape(-1, 1, 1, 1).astype(np.float32),
        clip_min=0.0,
        clip_max=(255 * K).reshape(-1, 1, 1, 1).astype(np.float32)))
    assert len(got) == len(want) == 3
    for (gl, gr), (wl, wr), (fl, fr) in zip(got, want, f32):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gl.astype(np.float32) * 0.5, fl)
        np.testing.assert_array_equal(gr.astype(np.float32) * 0.5, fr)


def test_pgd_takes_per_sample_bounds_on_the_integer_grid():
    """pgd_attack with (B, 1, 1, 1) alpha, eps and clip_max at the paper's
    K keeps every iterate on the integer grid, and the int32 replay of
    its packed signs reproduces the iterates bit for bit."""
    K = np.array([63584.0, 48000.0], np.float32).reshape(-1, 1, 1, 1)
    rng = np.random.RandomState(8)
    clean = T((rng.randint(0, 256, (2, 3, 8, 3)) * K).astype(np.float32))
    target = T(rng.normal(size=(2, 3, 8, 3)).astype(np.float32))

    def loss_fn(a, b):
        return ((a / 1e6 - target) ** 2).sum() + (b * target).sum()

    kw = dict(num_iters=4, alpha=K, eps=76.5 * K, clip_min=0.0,
              clip_max=255 * K)
    res = tpgd.pgd_attack(loss_fn, clean, clean.flip(0), collect=True, **kw)
    signs = tpgd.pgd_attack(loss_fn, clean, clean.flip(0), collect="signs",
                            **kw).trajectory
    c = _np(clean).astype(np.int32)
    replay = list(tpgd.replay_pgd_ints(
        2 * c, 2 * c[::-1], _np(signs[0]), _np(signs[1]),
        alpha2=2 * K.ravel(), eps2=153 * K.ravel(),
        clip_max2=510 * K.ravel()))
    for k in range(4):
        for side in (0, 1):
            it = _np(res.trajectory[side][k])
            assert np.array_equal(it, np.round(it))
            np.testing.assert_array_equal(
                replay[k][side].astype(np.float32) * 0.5, it)


def _target_case():
    """Random RPN outputs on the tiny anchors, and a gt batch of two
    images (one with no boxes)."""
    cfg = StereoRCNNConfig.tiny()
    rng = np.random.RandomState(11)
    shapes = tanc.fpn_feat_shapes(96, 320, cfg.feat_strides)
    anchors = tanc.pyramid_anchors(shapes, tuple(cfg.feat_strides),
                                   tuple(cfg.anchor_scales),
                                   tuple(cfg.anchor_ratios))
    n, g = anchors.shape[0], cfg.max_gt_boxes
    logits = rng.normal(size=(2, n, 2)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    d6 = rng.normal(0, 0.3, (2, n, 6)).astype(np.float32)
    gt = {"gt_left": np.zeros((2, g, 5), np.float32),
          "gt_right": np.zeros((2, g, 5), np.float32),
          "gt_merge": np.zeros((2, g, 4), np.float32),
          "gt_dim_orien": np.zeros((2, g, 5), np.float32),
          "gt_kpts": np.full((2, g, 6), -1.0, np.float32),
          "num_boxes": np.array([3, 0], np.int32)}
    for k, (x1, y1, x2, y2, disp) in enumerate(
            [(40, 30, 90, 70, 10), (150, 20, 260, 80, 20),
             (280, 50, 330, 95, 6)]):
        gt["gt_left"][0, k] = [x1, y1, x2, y2, 1]
        gt["gt_right"][0, k] = [x1 - disp, y1, x2 - disp, y2, 1]
        gt["gt_merge"][0, k] = [x1 - disp, y1, x2, y2]
        gt["gt_dim_orien"][0, k] = [1.5, 1.6, 3.9, 0.3 * k, 0.9]
        gt["gt_kpts"][0, k] = [k - 1, x1 + 20, x1, x2, 0, 0]
    return cfg, anchors, prob, d6, gt


def test_target_layers_match_jax_with_injected_draws():
    cfg, anchors, prob, d6, gt = _target_case()
    kw = dict(pre_nms_top_n=cfg.pre_nms_top_n,
              post_nms_top_n=cfg.post_nms_top_n,
              nms_thresh=cfg.rpn_nms_thresh, min_size=cfg.rpn_min_size)
    jp = jst.proposal_layer(prob, d6, anchors, (96, 320), **kw)
    tp = tst.proposal_layer(T(prob), T(d6), T(anchors), (96, 320), **kw)
    np.testing.assert_array_equal(_np(tp.valid), np.asarray(jp.valid))
    for got, want in zip(tp[:2], jp[:2]):
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-4)
    assert _np(tp.valid).sum() > 10

    n, m = anchors.shape[0], cfg.post_nms_top_n + cfg.max_gt_boxes
    # the JAX layers draw from keys; the port takes the same draws
    rng_a, rng_r = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    afg, abg = jax_layer_draws(rng_a, 2, n)
    rfg, rbg = jax_layer_draws(rng_r, 2, m)
    jat = jst.anchor_target_layer(
        anchors, gt["gt_left"][..., :4], gt["gt_right"][..., :4],
        gt["gt_merge"][..., :4], gt["num_boxes"], (96, 320), rng_a,
        batch_size=cfg.rpn_batch_size)
    tat = tst.anchor_target_layer(
        T(anchors), T(gt["gt_left"][..., :4]), T(gt["gt_right"][..., :4]),
        T(gt["gt_merge"][..., :4]), T(gt["num_boxes"]), (96, 320), T(afg),
        T(abg), batch_size=cfg.rpn_batch_size)
    np.testing.assert_array_equal(_np(tat.labels), np.asarray(jat.labels))
    assert (_np(tat.labels)[0] == 1).sum() > 0
    for got, want in zip(tat[1:], jat[1:]):
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)

    # the roi sampler on JAX's proposals, so both start from one set
    props = tst.Proposals(*(T(np.array(x)) for x in jp))
    jrt = jst.proposal_target_layer(
        jp, gt["gt_left"], gt["gt_right"], gt["gt_dim_orien"], gt["gt_kpts"],
        gt["num_boxes"], rng_r, roi_batch_size=cfg.roi_batch_size,
        kpts_grid=cfg.kpts_grid)
    trt = tst.proposal_target_layer(
        props, *(T(gt[k]) for k in ("gt_left", "gt_right", "gt_dim_orien",
                                    "gt_kpts", "num_boxes")), T(rfg),
        T(rbg), roi_batch_size=cfg.roi_batch_size, kpts_grid=cfg.kpts_grid)
    for name, got, want in zip(trt._fields, trt, jrt):
        if np.asarray(want).dtype.kind in "biu":
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert _np(trt.labels)[0].sum() > 0 and _np(trt.kpts_weight).sum() > 0


def jax_layer_draws(rng, bsz, n):
    """The (fg, bg) uniform draws a JAX target layer makes from `rng`:
    one key per image, split into a fg and a bg key."""
    fg, bg = [], []
    for key in jax.random.split(rng, bsz):
        kf, kb = jax.random.split(key)
        fg.append(np.asarray(jax.random.uniform(kf, (n,))))
        bg.append(np.asarray(jax.random.uniform(kb, (n,))))
    return np.stack(fg), np.stack(bg)
