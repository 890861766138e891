"""DSGN training in the port against the JAX trainer on CPU: parameter
gradients, optimizer and schedule, depth ground truth, checkpoints and
the training CLI end to end.

Tolerances: the loss within 1e-5 relative and each parameter's gradient
within 1e-4 x that parameter's largest gradient magnitude (the tiny
model in fp32 on both sides: the same arithmetic summed in other orders);
the optimizer's parameters within 1e-6 (identical gradients, f32 Adam
moments); depth maps exactly (the same numpy arithmetic).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
from eval_driving_safety_tpu.models.rpn3d_loss import \
    dsgn_total_loss as jax_total_loss
from eval_driving_safety_tpu_torch.cli import train_detector as T
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.models.rpn3d_loss import dsgn_total_loss
from eval_driving_safety_tpu_torch.utils import checkpoint as C
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax

MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)

# a KITTI calibration (drive 2011_09_26): rectified projections, R0 and
# the velodyne-to-camera transform
CALIB = (
    "P2: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 "
    "7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 "
    "1.000000e+00 2.745884e-03\n"
    "P3: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 "
    "7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 0.000000e+00 "
    "1.000000e+00 2.729905e-03\n"
    "R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 "
    "9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01\n"
    "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 "
    "-4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 -7.631618e-02 "
    "9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01\n")
LABEL = ("Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 18.0 "
         "0.4\n")


def _velodyne(rng, n=20000):
    """(N, 4) float32 scan in the sensor frame: x forward, y left, z up."""
    return np.stack([rng.uniform(-5.0, 70.0, n), rng.uniform(-25.0, 25.0, n),
                     rng.uniform(-2.0, 1.5, n), rng.uniform(0.0, 1.0, n)],
                    axis=1).astype(np.float32)


def _kitti_dir(root, ids, hw=(90, 300)):
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2", "velodyne"):
        os.makedirs(os.path.join(root, sub))
    for fid in ids:
        left = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        K.write_png(os.path.join(root, "image_2", fid + ".png"), left)
        K.write_png(os.path.join(root, "image_3", fid + ".png"),
                    np.roll(left, -5, axis=1))
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write(LABEL)
        _velodyne(rng).tofile(os.path.join(root, "velodyne", fid + ".bin"))


# ------------------------------------------------ parameter gradients


def _train_inputs():
    """Seeded u8 frames normalized as the trainers normalize them."""
    rng = np.random.RandomState(0)
    b, h, w = 1, 96, 320
    il = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    ir = np.clip(np.roll(il.astype(int), -6, axis=2)
                 + rng.randint(-8, 9, il.shape), 0, 255).astype(np.uint8)
    norm = lambda u8: ((u8.astype(np.float32) / 255.0 - MEAN) / STD)
    calib = [np.full((b,), v, np.float32) for v in (180.0, 0.54, 160.0, 48.0)]
    depth = np.where(rng.rand(b, h, w) < 0.5,
                     rng.uniform(1.0, 70.0, (b, h, w)), 0.0).astype(np.float32)
    boxes = np.zeros((b, 4, 8), np.float32)
    boxes[0, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    boxes[0, 1] = [-6.0, 1.5, 30.0, 1.6, 1.8, 3.8, -1.2, 1.0]
    return norm(il), norm(ir), calib, depth, boxes, np.array([2], np.int32)


@pytest.fixture(scope="module")
def grads_pair():
    """(JAX loss, JAX gradients bridged to the port's names, port loss,
    port gradients) of the tiny fp32 DSGN on the same weights."""
    il, ir, calib, depth, boxes, nb = _train_inputs()
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    jm = JaxDSGN(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), il, ir, *calib)

    def loss_fn(p):
        out = jm.apply(p, il, ir, *calib)
        return jax_total_loss(out, depth, boxes, nb, jcfg)[0]

    jtotal, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    model = DSGN(tcfg)
    model.load_state_dict(dsgn_state_dict_from_flax(to_np(params)))
    t = torch.from_numpy
    out = model(t(il), t(ir), *[t(c) for c in calib])
    total, _ = dsgn_total_loss(out, t(depth), t(boxes), t(nb).long(), tcfg)
    total.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return (float(jtotal), dsgn_state_dict_from_flax(to_np(jgrads)),
            float(total.detach()), grads)


def test_training_loss_matches_jax(grads_pair):
    jtotal, _, total, _ = grads_pair
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)


def test_every_parameter_gradient_matches_jax(grads_pair):
    """All 177 leaves, the FrozenBatchNorm statistics (through rsqrt(var
    + eps)) included. A Score3D bias adds one constant to every plane's
    score, which the soft-argmin's softmax cancels: its gradient is 0 up
    to rounding on both sides (about 1e-8 here), so it is held at 1e-4 x
    the largest gradient of that layer's weight instead."""
    _, jgrads, _, grads = grads_pair
    assert set(grads) == set(jgrads) and len(grads) == 177
    worst = {}
    for name, g in grads.items():
        want = jgrads[name].numpy()
        ref = name.replace(".bias", ".weight") \
            if name.startswith("depth_score") else name
        scale = float(np.abs(jgrads[ref].numpy()).max())
        assert scale > 0, f"{name}: the reference gradient is all zero"
        worst[name] = float(np.abs(g - want).max()) / scale
    bad = {k: v for k, v in worst.items() if v > 1e-4}
    assert not bad, f"gradients off by more than 1e-4 x max: {bad}"


# -------------------------------------------------- optimizer, schedule


@pytest.mark.parametrize("warmup,decay", [(3, 10), (0, 5), (4, 5)])
def test_schedule_matches_optax(warmup, decay):
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup, decay)
    got = T.warmup_cosine_decay(2e-3, warmup, decay)
    for n in range(decay + 3):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6,
                                   atol=1e-12)
    assert got(0) == (0.0 if warmup else 2e-3)


def _state():
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return {"params": {"backbone": {
        "stem_conv": {"kernel": f(3, 3)},
        "stem_bn": {"scale": 1 + 0.1 * f(4), "bias": f(4),
                    "mean": f(4), "var": 1 + np.abs(f(4))}}},
        "uncert": f(6)}


def test_detector_optimizer_matches_optax():
    """Four updates from the same gradients (the second large enough for
    the global-norm clip): adamw with decay on the weights and BN
    scale/bias, decay-free adam on `uncert`, `mean`/`var` frozen, the
    learning rate read at the count before each update (the first update
    has lr 0). Parameters within 1e-6; `mean`/`var` bit for bit."""
    from eval_driving_safety_tpu.cli.train_detector import \
        make_detector_optimizer as jax_make
    state = _state()
    sched_args = (1e-2, 2, 6)
    tx = jax_make(optax.warmup_cosine_decay_schedule(0.0, *sched_args))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    opt_state = tx.init(jstate)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(state)}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in flat.items()}
    opt = T.make_detector_optimizer(tparams.items(),
                                    T.warmup_cosine_decay(*sched_args))
    rng = np.random.RandomState(4)
    for step in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 * (100.0 if step == 1 else 0.3) for k, v in flat.items()}
        gtree = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(grads[".".join(
                str(getattr(k, "key", k)) for k in path)]), state)
        if step == 1:
            norm = np.sqrt(sum((g ** 2).sum() for g in grads.values()))
            assert norm > 10.0                       # the clip triggers
        updates, opt_state = tx.update(gtree, opt_state, jstate)
        jstate = optax.apply_updates(jstate, updates)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for path, v in jax.tree_util.tree_leaves_with_path(jstate):
            k = ".".join(str(getattr(p, "key", p)) for p in path)
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(v), rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {k}")
        if step == 0:                                # lr 0: nothing moved
            for k, p in tparams.items():
                assert np.array_equal(p.detach().numpy(), flat[k]), k
    for k in ("params.backbone.stem_bn.mean", "params.backbone.stem_bn.var"):
        assert np.array_equal(tparams[k].detach().numpy(), flat[k]), k
    for k in ("params.backbone.stem_conv.kernel", "uncert"):
        assert not np.array_equal(tparams[k].detach().numpy(), flat[k]), k
    assert opt.count == 4


def test_optimizer_state_roundtrips_through_a_checkpoint(tmp_path):
    """A resumed optimizer continues exactly as the one that kept
    running: same moments, same schedule count."""
    sched = T.warmup_cosine_decay(1e-2, 1, 8)

    def make():
        g = torch.Generator().manual_seed(0)
        return {"w": torch.nn.Parameter(torch.randn(5, generator=g)),
                "bn.var": torch.nn.Parameter(torch.ones(5))}

    def step(params, opt, k):
        opt.zero_grad()
        for name, p in params.items():
            p.grad = torch.full_like(p, 0.1 * (k + 1))
        opt.step()

    a = make()
    opt_a = T.make_detector_optimizer(a.items(), sched)
    for k in range(2):
        step(a, opt_a, k)
    C.save_checkpoint(str(tmp_path / "epoch1"), {
        "params": {k: v.detach() for k, v in a.items()},
        "opt_state": opt_a.state_dict(), "epoch": 1})
    b = make()
    opt_b = T.make_detector_optimizer(b.items(), sched)
    ck = C.restore_checkpoint(C.latest_epoch_dir(str(tmp_path)))
    with torch.no_grad():
        for k, p in b.items():
            p.copy_(ck["params"][k])
    opt_b.load_state_dict(ck["opt_state"])
    assert ck["epoch"] == 1 and opt_b.count == 2
    for k in range(2, 4):
        step(a, opt_a, k)
        step(b, opt_b, k)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_latest_epoch_dir(tmp_path):
    assert C.latest_epoch_dir(str(tmp_path / "missing")) is None
    for n in (0, 3, 12):
        (tmp_path / f"epoch{n}").mkdir()
    (tmp_path / "epochx").mkdir()
    (tmp_path / "other").mkdir()
    assert C.latest_epoch_dir(str(tmp_path)).endswith("epoch12")


# ------------------------------------------------------ depth ground truth


def test_depth_map_equals_jax(tmp_path):
    from eval_driving_safety_tpu.cli.make_depth_gt import \
        velodyne_to_depth_map as jax_depth_map
    from eval_driving_safety_tpu.data.kitti import read_calib as jax_calib
    from eval_driving_safety_tpu_torch.cli.make_depth_gt import (
        main, velodyne_to_depth_map)
    path = tmp_path / "calib.txt"
    path.write_text(CALIB)
    pts = _velodyne(np.random.RandomState(7), 120000)
    got = velodyne_to_depth_map(pts, K.read_calib(str(path)), 384, 1248)
    want = jax_depth_map(pts, jax_calib(str(path)), 384, 1248)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert (got > 0).sum() > 1000
    # the CLI: velodyne/<id>.bin + calib/<id>.txt -> <out_dir>/<id>.npy
    data = tmp_path / "kitti"
    for sub in ("velodyne", "calib"):
        (data / sub).mkdir(parents=True)
    pts.tofile(data / "velodyne" / "000003.bin")
    (data / "calib" / "000003.txt").write_text(CALIB)
    main(["--data_path", str(data), "--out_dir", str(tmp_path / "depth")])
    assert np.array_equal(np.load(tmp_path / "depth" / "000003.npy"), want)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_drop_remainder_as_jax(tmp_path, drop, prefetch):
    from eval_driving_safety_tpu.data.dataset import \
        KittiStereoDataset as JaxDataset
    from eval_driving_safety_tpu_torch.data.dataset import KittiStereoDataset
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ["000001", "000002", "000003"], hw=(8, 12))
    ids = lambda batches: [[s.frame_id for s in b] for b in batches]
    got = ids(KittiStereoDataset(data).batches(2, drop_remainder=drop,
                                               prefetch=prefetch))
    want = ids(JaxDataset(data, dtype="uint8").batches(
        2, drop_remainder=drop, prefetch=prefetch))
    assert got == want
    assert len(got) == (1 if drop else 2)


# ------------------------------------------------------------ CLI, end to end


def _bn_stats(sd):
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in
            ("mean", "var")}


def test_train_cli_checkpoints_resumes_and_feeds_the_attack(tmp_path,
                                                            capsys):
    from eval_driving_safety_tpu_torch.cli import make_depth_gt, pgd_attack
    data, ck = str(tmp_path / "kitti"), str(tmp_path / "ck")
    _kitti_dir(data, ["000001", "000002"])
    make_depth_gt.main(["--data_path", data, "--out_dir",
                        str(tmp_path / "depth"), "--height", "96",
                        "--width", "320"])
    common = ["--data_path", data, "--detector", "dsgn", "--tiny",
              "--device", "cpu", "--batch", "1", "--ckpt_every", "1",
              "--warmup_steps", "1", "--ckpt_dir", ck,
              "--depth_dir", str(tmp_path / "depth")]
    T.main(common + ["--epochs", "1"])
    assert sorted(os.listdir(ck)) == ["epoch1"]
    T.main(common + ["--epochs", "1", "--resume"])
    out = capsys.readouterr().out
    assert f"resumed from {os.path.join(ck, 'epoch1')} (epoch 1)" in out
    assert "epoch 2: loss" in out and sorted(os.listdir(ck)) == [
        "epoch1", "epoch2"]
    init = DSGN(DSGNConfig.tiny()).init_weights(0).state_dict()
    e1 = C.restore_checkpoint(os.path.join(ck, "epoch1"))
    e2 = C.restore_checkpoint(os.path.join(ck, "epoch2"))
    assert e1["epoch"] == 1 and e2["epoch"] == 2
    assert e2["opt_state"]["count"] == 4                 # 2 frames x 2 epochs
    for k, v in _bn_stats(init).items():
        assert torch.equal(e1["params"][k], v) and \
            torch.equal(e2["params"][k], v), k
    # the second epoch's updates (lr > 0) moved the weights
    w = "StereoFeatureNet_0.ConvBnRelu_0.Conv_0.weight"
    assert not torch.equal(e2["params"][w], init[w])
    # the attack CLI takes the trainer's epoch directory as --ckpt
    pgd_attack.main(["--data_path", data, "--detector", "dsgn", "--scale",
                     "tiny", "--iter", "1", "--batch", "1", "--device",
                     "cpu", "--ckpt", os.path.join(ck, "epoch1"),
                     "--out_prefix", str(tmp_path / "adv" / "dsgn_pgd")])
    out = capsys.readouterr().out
    assert f"loaded DSGN weights from {os.path.join(ck, 'epoch1')}" in out
    assert os.path.exists(tmp_path / "adv" / "dsgn_pgd_iters_1" / "image_2"
                          / "000002.png")


def test_attack_refuses_checkpoints_it_cannot_read(tmp_path):
    """An orbax-style directory (no checkpoint.pt) and a trainer
    checkpoint of another scale are refused, naming the ROADMAP item of
    the JAX trainer's checkpoints."""
    from eval_driving_safety_tpu_torch.cli import pgd_attack
    orbax = tmp_path / "orbax" / "epoch3"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    tiny = DSGN(DSGNConfig.tiny()).init_weights(0)
    C.save_checkpoint(str(tmp_path / "tiny"), {
        "params": tiny.state_dict(), "opt_state": {}, "epoch": 1})
    for ckpt, scale in ((orbax, "tiny"), (tmp_path / "tiny", "default")):
        with pytest.raises(SystemExit, match="ROADMAP item 13"):
            pgd_attack.main(["--data_path", str(tmp_path), "--scale", scale,
                             "--device", "cpu", "--ckpt", str(ckpt)])


def test_train_cli_refuses_srcnn(tmp_path, capsys):
    """`--detector srcnn` trains (it was refused before Stereo R-CNN
    training was ported): one tiny epoch, logged with `uncert`, and a
    checkpoint of the network, `uncert`, the optimizer and the epoch."""
    from test_torch_cli import _kitti_dir
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ["000001"])
    ck = str(tmp_path / "ck")
    T.main(["--data_path", data, "--detector", "srcnn", "--tiny",
            "--device", "cpu", "--epochs", "1", "--ckpt_dir", ck])
    assert "epoch 1: loss " in capsys.readouterr().out
    saved = C.restore_checkpoint(os.path.join(ck, "epoch1"))
    assert set(saved) == {"params", "uncert", "opt_state", "epoch"}
    assert saved["uncert"].shape == (6,) and saved["epoch"] == 1
