"""The ported Stereo R-CNN against the JAX reference on CPU: the tiny
config in fp32, the same seeded inputs, the same (bridged) weights and
the same sampler draws (the port takes the uniforms that the JAX model
draws from its key).

Tolerances: the six losses and the total within 1e-4 relative; outputs
within 1e-4 of their largest magnitude, the keypoint softmaxes within
1e-3 (`OUTPUTS`); input gradients within 1e-3 of
their largest magnitude; rois within 1e-4 of the image width; labels,
validity masks and sampled roi indices equal. Both sides compute in f32
but sum in other orders (convs, dense layers, ROIAlign, softmaxes), and
the gradient runs back through the trunk twice (the rois' targets carry
the RPN's box gradient).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.config import StereoRCNNConfig as JaxCfg
from eval_driving_safety_tpu.models.stereo_rcnn import StereoRCNN as JaxRCNN
from eval_driving_safety_tpu.models.stereo_rcnn import \
    total_attack_loss as jax_total
from eval_driving_safety_tpu_torch.models.common import cast_matmul_params
from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
    LOSS_NAMES, StereoRCNN, total_attack_loss)
from eval_driving_safety_tpu_torch.models.stereo_targets import SamplingDraws
from eval_driving_safety_tpu_torch.utils.from_flax import \
    stereo_rcnn_state_dict_from_flax

MEANS = np.asarray((102.9801, 115.9465, 122.7717), np.float32)
RNG = jax.random.PRNGKey(2)
UNCERT = np.asarray([0.3, -0.2, 0.1, 0.5, -0.4, 0.2], np.float32)
# output -> tolerance relative to its largest magnitude. The keypoint
# logits (column sums of 28 rows of a 256-channel conv stack) span ~80, so
# their f32 sum-order error of ~1e-6 relative moves a probability near 0.3
# by ~1e-4: the keypoint and border softmaxes are held to 1e-3
OUTPUTS = {"cls_prob": 1e-4, "bbox_pred": 1e-4, "dim_orien_pred": 1e-4,
           "kpts_prob": 1e-3, "left_border_prob": 1e-3,
           "right_border_prob": 1e-3}


def _inputs(cfg):
    rng = np.random.RandomState(0)
    h, w = cfg.input.height, cfg.input.width
    left = rng.randint(0, 256, (1, h, w, 3)).astype(np.float32)
    right = np.clip(np.roll(left, -6, axis=2) + rng.randint(-8, 9, left.shape),
                    0, 255)
    g = cfg.max_gt_boxes
    gt = {"gt_left": np.zeros((1, g, 5), np.float32),
          "gt_right": np.zeros((1, g, 5), np.float32),
          "gt_merge": np.zeros((1, g, 4), np.float32),
          "gt_dim_orien": np.zeros((1, g, 5), np.float32),
          "gt_kpts": np.full((1, g, 6), -1.0, np.float32),
          "num_boxes": np.array([2], np.int32)}
    for k, (x1, y1, x2, y2, d, kt) in enumerate(
            [(40, 30, 90, 70, 10, 1), (150, 20, 260, 80, 20, 2)]):
        gt["gt_left"][0, k] = [x1, y1, x2, y2, 1]
        gt["gt_right"][0, k] = [x1 - d, y1, x2 - d, y2, 1]
        gt["gt_merge"][0, k] = [x1 - d, y1, x2, y2]
        gt["gt_dim_orien"][0, k] = [1.5, 1.6, 3.9, 0.4 * k, 0.9]
        gt["gt_kpts"][0, k] = [kt, x1 + 20, x1, x2, 0, 0]
    return left - MEANS, right.astype(np.float32) - MEANS, gt


def jax_model_draws(rng, bsz, n_anchors, n_rois):
    """The uniforms the JAX StereoRCNN draws in attack mode from `rng`:
    split into the anchor and the roi sampler's keys, one key per image,
    each split into fg and bg."""
    out = []
    for key, n in zip(jax.random.split(rng), (n_anchors, n_rois)):
        fg, bg = [], []
        for k in jax.random.split(key, bsz):
            kf, kb = jax.random.split(k)
            fg.append(np.asarray(jax.random.uniform(kf, (n,))))
            bg.append(np.asarray(jax.random.uniform(kb, (n,))))
        out += [np.stack(fg), np.stack(bg)]
    return SamplingDraws(*(torch.from_numpy(x) for x in out))


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxCfg.tiny()
    il, ir, gt = _inputs(cfg)
    return jax.jit(lambda k, a, b: JaxRCNN(cfg).init(
        k, a, b, gt=gt, rng=RNG, mode="attack"))(jax.random.PRNGKey(1), il,
                                                 ir)


@pytest.fixture(scope="module", params=["conv7", "s2d"])
def attack_pair(request, jax_params):
    """JAX attack-mode results (uncert != 0) for one stem, and the port's."""
    stem = request.param
    jcfg = dataclasses.replace(JaxCfg.tiny(), stem_method=stem)
    tcfg = dataclasses.replace(StereoRCNNConfig.tiny(), stem_method=stem)
    il, ir, gt = _inputs(jcfg)
    jm = JaxRCNN(jcfg)

    def loss(a, b, u):
        out = jm.apply(jax_params, a, b, gt=gt, rng=RNG, mode="attack")
        return jax_total(out.losses, u), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(il, ir, UNCERT)
    model = StereoRCNN(tcfg)
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(jax_params, model))
    model.requires_grad_(False)
    draws = jax_model_draws(RNG, 1, model.anchors.shape[0],
                            tcfg.post_nms_top_n + tcfg.max_gt_boxes)
    a = torch.from_numpy(il).requires_grad_(True)
    b = torch.from_numpy(ir).requires_grad_(True)
    out = model(a, b, gt={k: torch.from_numpy(v) for k, v in gt.items()},
                draws=draws, mode="attack")
    total = total_attack_loss(out.losses, torch.from_numpy(UNCERT))
    tg = torch.autograd.grad(total, (a, b))
    return (float(jl), jout, [np.asarray(g) for g in jg]), \
        (float(total.detach()), out, [g.numpy() for g in tg])


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30))


def test_losses_and_total_match_jax(attack_pair):
    (jl, jout, _), (tl, tout, _) = attack_pair
    for k in LOSS_NAMES:
        want, got = float(jout.losses[k]), float(tout.losses[k].detach())
        assert abs(got - want) <= 1e-4 * abs(want), k
        assert want > 0, k
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    # the weighting itself: a nonzero uncert moves the total
    assert abs(tl - sum(float(v.detach()) for v in tout.losses.values())) \
        > 0.1


def test_rois_labels_and_outputs_match_jax(attack_pair):
    (_, jout, _), (_, tout, _) = attack_pair
    np.testing.assert_array_equal(tout.roi_valid.numpy(),
                                  np.asarray(jout.roi_valid))
    np.testing.assert_array_equal(tout.rois_label.numpy(),
                                  np.asarray(jout.rois_label))
    assert tout.rois_label.sum() > 0 and tout.roi_valid.sum() > 4
    for name in ("rois_left", "rois_right"):
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=1e-4 * 320)
    for name, tol in OUTPUTS.items():
        _close(getattr(tout, name), getattr(jout, name), tol)


def test_input_gradients_match_jax(attack_pair):
    (_, _, jg), (_, _, tg) = attack_pair
    for g, want in zip(tg, jg):
        assert np.abs(want).max() > 0
        _close(g, want, 1e-3)


def test_infer_mode_matches_jax(jax_params):
    jcfg, tcfg = JaxCfg.tiny(), StereoRCNNConfig.tiny()
    il, ir, _ = _inputs(jcfg)
    jout = jax.jit(lambda a, b: JaxRCNN(jcfg).apply(
        jax_params, a, b, mode="infer"))(il, ir)
    model = StereoRCNN(tcfg)
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(jax_params, model))
    with torch.no_grad():
        out = model(torch.from_numpy(il), torch.from_numpy(ir), mode="infer")
    assert out.rois_label is None
    assert all(float(v) == 0.0 for v in out.losses.values())
    assert out.cls_prob.shape == (1, tcfg.post_nms_top_n, 2)
    np.testing.assert_array_equal(out.roi_valid.numpy(),
                                  np.asarray(jout.roi_valid))
    np.testing.assert_allclose(out.rois_left.numpy(),
                               np.asarray(jout.rois_left), rtol=0,
                               atol=1e-4 * 320)
    for name, tol in OUTPUTS.items():
        _close(getattr(out, name), getattr(jout, name), tol)


def test_init_weights_follow_flax_distributions(jax_params):
    """Each kernel's fresh init has the spread of Flax's (lecun normal on
    the Flax layout's fan-in, the transposed conv's included); biases and
    BatchNorm take Flax's constants."""
    model = StereoRCNN(StereoRCNNConfig.tiny())
    bridged = stereo_rcnn_state_dict_from_flax(jax_params, model)
    mine = model.init_weights(seed=0).state_dict()
    assert set(mine) == set(bridged)
    for k, v in bridged.items():
        if k.endswith("weight") and v.numel() >= 4096:
            assert abs(float(mine[k].std()) / float(v.std()) - 1) < 0.1, k
        elif not k.endswith("weight"):
            np.testing.assert_array_equal(mine[k].numpy(), v.numpy(), k)


def test_bf16_trunk_casts_kernels_once_and_keeps_losses_f32(jax_params):
    cfg = dataclasses.replace(StereoRCNNConfig.tiny(), dtype="bfloat16")
    model = StereoRCNN(cfg)
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(jax_params, model))
    cast_matmul_params(model.requires_grad_(False))
    for name, p in model.named_parameters():
        want = torch.bfloat16 if p.dim() >= 2 else torch.float32
        assert p.dtype == want, name
    assert model.anchors.dtype == torch.float32
    il, ir, gt = _inputs(cfg)
    draws = jax_model_draws(RNG, 1, model.anchors.shape[0],
                            cfg.post_nms_top_n + cfg.max_gt_boxes)
    a = torch.from_numpy(il).requires_grad_(True)
    out = model(a, torch.from_numpy(ir),
                gt={k: torch.from_numpy(v) for k, v in gt.items()},
                draws=draws, mode="attack")
    total = total_attack_loss(out.losses, torch.zeros(6))
    (g,) = torch.autograd.grad(total, (a,))
    assert total.dtype == torch.float32 and out.cls_prob.dtype == \
        torch.float32
    assert torch.isfinite(total) and torch.isfinite(g).all() and \
        g.abs().max() > 0
