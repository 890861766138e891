"""Stereo R-CNN training and the published-checkpoint import in the port,
against the JAX package on CPU at the tiny config in fp32.

* Two training steps against the JAX trainer's step (its optimizer chain
  and schedule, the u8 ingest), each with the sampler draws the JAX model
  makes from that step's key: the total loss within 1e-4 relative and
  the six terms within 1e-3 (1e-6 absolute for a term near 0; the
  sampled rois come from the RPN's decoded deltas and differ by up to
  1e-3 px between the packages, which moves the cross-entropy of a roi
  whose label is unlikely, and a term that averages 6 rois, by about
  1e-4 relative), each sampled
  parameter's clipped gradient within 1e-3 of its largest magnitude, as
  the Stereo R-CNN attack tests hold input gradients; `uncert` and the
  sampled parameters after the second step (the first has lr 0) within
  1e-6 plus 2e-3 of the step's learning rate for an element whose
  gradient is below 1e-3 of the largest (Adam divides by the root of the
  squared gradient, so a gradient near 0 leaves its sign, and the
  element's step, to rounding); FrozenBatchNorm statistics bit for bit.
* The published `.pth` through both packages' importers, with and
  without the DataParallel `module.` prefix: 0 unmapped keys, the file's
  `uncert`, and the tiny model's infer outputs within the attack tests'
  tolerances (`OUTPUTS`).
* The training CLI run, resumed, and its checkpoint attacked.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eval_driving_safety_tpu.cli.train_detector import \
    make_detector_optimizer as jax_optimizer
from eval_driving_safety_tpu.config import StereoRCNNConfig as JaxCfg
from eval_driving_safety_tpu.data import dataset as JD
from eval_driving_safety_tpu.models import stereo_rcnn as JS
from eval_driving_safety_tpu.utils import torch_import as JTI
from eval_driving_safety_tpu_torch.cli import train_detector as T
from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.data.dataset import (
    KittiStereoDataset, prepare_srcnn_batch_u8)
from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
    LOSS_NAMES, StereoRCNN, make_gt_batch)
from eval_driving_safety_tpu_torch.utils import checkpoint as CK
from eval_driving_safety_tpu_torch.utils import torch_import as TI
from eval_driving_safety_tpu_torch.utils.from_flax import \
    stereo_rcnn_state_dict_from_flax
from test_torch_cli import _kitti_dir
from test_torch_import import _synthetic_upstream_sd
from test_torch_stereo_rcnn import OUTPUTS, jax_model_draws

LR, WARMUP, DECAY = 1e-3, 2, 50
# (kpts_class's bias has a gradient of exactly 0: its logits are summed
# over the rows into a softmax over the columns, which a shift leaves be)
SAMPLED = ("backbone.stem_conv.weight",
           "backbone.layer2_block0.Conv_1.weight", "fpn.smooth1.bias",
           "rpn.rpn_cls.bias", "rpn.rpn_box.weight", "rcnn.fc1.weight",
           "rcnn.cls_score.bias", "rcnn.bbox_pred.weight",
           "rcnn.dim_orien_pred.bias", "kpts.kpts_deconv.weight",
           "kpts.kpts_class.weight")


def _close(got, want, rtol, atol=0.0):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want) + atol, (got, want)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """The JAX trainer's step (cli/train_detector.py run_srcnn) twice on
    one frame, with two keys: per step the loss, the terms, the clipped
    gradients and the state after it; the initial variables."""
    data = str(tmp_path_factory.mktemp("srcnn_train") / "kitti")
    _kitti_dir(data, ["000001"])
    cfg = JaxCfg.tiny()
    model = JS.StereoRCNN(cfg)
    samples = [JD.KittiStereoDataset(data, dtype="uint8").get(0)]
    b = JD.prepare_srcnn_batch_u8(samples, cfg.input)
    gt = JS.make_gt_batch(b["objects"], b["calibs"], cfg,
                          image_scale=b["scales"])
    wargs = {k: jnp.asarray(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                            "wmask", "c")}
    means = np.asarray(cfg.input.pixel_means_bgr, np.float32)
    il_u8, ir_u8 = jnp.asarray(b["im_left_u8"]), jnp.asarray(b["im_right_u8"])
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    il = JD.srcnn_clean01_device(wargs, il_u8) * 255.0 - means
    ir = JD.srcnn_clean01_device(wargs, ir_u8) * 255.0 - means
    variables = dict(jax.jit(lambda a, c: model.init(
        jax.random.PRNGKey(1), a, c, gt=gt, rng=keys[0], mode="attack"))(
        il, ir))
    constants = {k: v for k, v in variables.items() if k != "params"}
    tx = jax_optimizer(optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP,
                                                          DECAY))

    @jax.jit
    def train_step(state, opt_state, rng):
        def loss_fn(st):
            out = model.apply({"params": st["params"], **constants},
                              JD.srcnn_clean01_device(wargs, il_u8) * 255.0
                              - means,
                              JD.srcnn_clean01_device(wargs, ir_u8) * 255.0
                              - means, gt=gt, rng=rng, mode="attack")
            return JS.total_attack_loss(out.losses, st["uncert"]), out.losses
        (total, parts), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state)
        clipped, _ = optax.clip_by_global_norm(10.0).update(grads, None)
        updates, opt_state = tx.update(grads, opt_state, state)
        return (optax.apply_updates(state, updates), opt_state, total, parts,
                clipped)

    state = {"params": variables["params"], "uncert": jnp.zeros((6,))}
    opt_state = tx.init(state)
    steps = []
    for key in keys:
        state, opt_state, total, parts, grads = train_step(state, opt_state,
                                                           key)
        steps.append({"key": key, "total": total, "parts": parts,
                      "grads": grads, "state": state})
    return data, variables, steps


def test_two_training_steps_match_jax(jax_steps):
    data, variables, steps = jax_steps
    cfg = StereoRCNNConfig.tiny()
    model = StereoRCNN(cfg)
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(variables, model))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    anchors = model.anchors.clone()
    uncert = torch.nn.Parameter(torch.zeros(6))
    opt = T.make_detector_optimizer(
        [*model.named_parameters(), ("uncert", uncert)],
        T.warmup_cosine_decay(LR, WARMUP, DECAY))
    step = T.make_srcnn_train_step(model, uncert, opt, cfg,
                                   torch.device("cpu"))
    ds = KittiStereoDataset(data)
    b = prepare_srcnn_batch_u8([ds.get(0)], cfg.input)
    gt = make_gt_batch(b["objects"], b["calibs"], cfg,
                       image_scale=b["scales"])
    weights = {k: torch.as_tensor(b[k]) for k in ("ih", "iw", "den_h",
                                                  "den_w", "wmask", "c")}
    n_rois = cfg.post_nms_top_n + cfg.max_gt_boxes
    for i, want in enumerate(steps):
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        total, parts = step(
            torch.as_tensor(b["im_left_u8"]), torch.as_tensor(
                b["im_right_u8"]), weights, gt,
            jax_model_draws(want["key"], 1, anchors.shape[0], n_rois))
        _close(total, want["total"], 1e-4)
        for k in LOSS_NAMES:
            _close(parts[k], want["parts"][k], 1e-3, 1e-6)
        grads = stereo_rcnn_state_dict_from_flax(want["grads"]["params"],
                                                 model)
        after = stereo_rcnn_state_dict_from_flax(want["state"]["params"],
                                                 model)
        params = dict(model.named_parameters())
        lr = T.warmup_cosine_decay(LR, WARMUP, DECAY)(i)
        for name in SAMPLED:
            g, p = grads[name].numpy(), params[name]
            gmax = np.abs(g).max()
            assert np.abs(p.grad.numpy() - g).max() <= 1e-3 * gmax, name
            tol = 1e-6 + 2e-3 * lr + 2 * lr * (np.abs(g) < 1e-3 * gmax)
            dev = np.abs(p.detach().numpy() - after[name].numpy())
            assert (dev <= tol).all(), (name, dev.max())
            if i == 0:                                   # lr 0
                assert torch.equal(p.detach(), before[name]), name
        np.testing.assert_allclose(
            uncert.detach().numpy(), np.asarray(want["state"]["uncert"]),
            rtol=0, atol=1e-6 + 2e-3 * lr)
        assert i == 0 or np.abs(uncert.detach().numpy()).min() > 0.5 * lr
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            assert torch.equal(v, init[k]), k
    assert torch.equal(model.anchors, anchors)


def _upstream(tmp_path, wrapped):
    """The tiny config's upstream-layout state dict as a published `.pth`
    file: {"model": tensors, "uncert": (6,)}."""
    sd = _synthetic_upstream_sd(JaxCfg.tiny())
    pre = "module." if wrapped else ""
    path = str(tmp_path / "stereo_rcnn_published.pth")
    uncert = torch.tensor([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0])
    torch.save({"model": {pre + k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()},
                "uncert": uncert, "epoch": 12}, path)
    return path, uncert


@pytest.mark.parametrize("wrapped", [False, True])
def test_published_pth_reads_like_jax(tmp_path, wrapped):
    path, uncert = _upstream(tmp_path, wrapped)
    jsd, juncert = JTI.load_torch_state_dict(path)
    jimp = JTI.import_stereo_rcnn(jsd)
    assert jimp["unmapped"] == []
    model, imported, got_uncert = TI.load_stereo_rcnn_checkpoint(
        path, StereoRCNNConfig.tiny())
    assert imported["unmapped"] == [] and imported["num_kpts_convs"] == 4
    assert torch.equal(got_uncert, uncert)
    np.testing.assert_array_equal(juncert, uncert.numpy())
    # the port's own import reports a key it does not read
    sd, _ = TI.load_torch_state_dict(path)
    sd["module.extra.weight" if wrapped else "extra.weight"] = torch.ones(2)
    assert TI.import_stereo_rcnn(sd)["unmapped"] == ["extra.weight"]

    cfg = JaxCfg.tiny()
    jm = JS.StereoRCNN(cfg)
    h, w = cfg.input.height, cfg.input.width
    x = np.random.RandomState(3).uniform(-120, 120, (1, h, w, 3)).astype(
        np.float32)
    y = np.roll(x, -4, axis=2)
    tree = dict(jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, a,
                                          mode="infer"))(x))
    tree = JTI.graft_stereo_rcnn(tree, jimp)
    want = jax.jit(lambda t, a, c: jm.apply(t, a, c, mode="infer"))(
        tree, x, y)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(y),
                           mode="infer")
    for name, tol in OUTPUTS.items():
        g, v = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.isfinite(v).all()
        assert np.abs(g - v).max() <= tol * np.abs(v).max(), name


def test_train_cli_resumes_and_its_checkpoint_is_attacked(tmp_path, capsys):
    from eval_driving_safety_tpu_torch.cli import pgd_attack
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ["000001", "000002"])
    ck = str(tmp_path / "ck")
    common = ["--data_path", data, "--detector", "srcnn", "--tiny",
              "--device", "cpu", "--ckpt_every", "2", "--warmup_steps", "1",
              "--ckpt_dir", ck]
    T.main(common + ["--epochs", "1"])
    # the resumed run's schedule spans its own 2 epochs, as in JAX: its
    # rates are 0.75 and 0.25 of the peak in its first epoch
    T.main(common + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert f"resumed from {os.path.join(ck, 'epoch1')} (epoch 1)" in out
    for e in (1, 2, 3):
        assert f"epoch {e}: loss " in out
    assert out.count(" uncert [") == 3
    # every --ckpt_every epochs and after each run's last
    assert sorted(os.listdir(ck)) == ["epoch1", "epoch2", "epoch3"]
    e1 = CK.restore_checkpoint(os.path.join(ck, "epoch1"))
    e2 = CK.restore_checkpoint(os.path.join(ck, "epoch2"))
    assert set(e2) == {"params", "uncert", "opt_state", "epoch"}
    assert e1["epoch"] == 1 and e2["epoch"] == 2
    assert e2["opt_state"]["count"] == 4                 # 2 frames x 2 epochs
    init = StereoRCNN(StereoRCNNConfig.tiny()).init_weights(0).state_dict()
    for k, v in init.items():
        if k.endswith((".mean", ".var")):
            assert torch.equal(e2["params"][k], v), k
    w = "rcnn.cls_score.weight"
    assert not torch.equal(e2["params"][w], e1["params"][w])
    assert e2["uncert"].abs().min() > 0 and \
        not torch.equal(e2["uncert"], e1["uncert"])

    pgd_attack.main(["--data_path", data, "--detector", "srcnn", "--tiny",
                     "--iter", "1", "--device", "cpu", "--ckpt",
                     os.path.join(ck, "epoch2"), "--out_prefix",
                     str(tmp_path / "adv" / "p")])
    out = capsys.readouterr().out
    assert f"loaded Stereo R-CNN weights from {os.path.join(ck, 'epoch2')}, " \
           f"uncert {e2['uncert'].tolist()}" in out
    assert os.path.exists(tmp_path / "adv" / "p_iters_1" / "image_2" /
                          "000002.png")
