"""The port's Stereo R-CNN patch attack against the JAX package on CPU:
the patch's targets, one patch step of the tiny fp32 model on bridged
weights, and the patch CLI with predict on its patch.

Tolerances: the targets are exact. The step: the six-term loss within
1e-4 relative (f32 sums in other orders, as in test_torch_stereo_rcnn.py)
and the new patch within 1e-5, the per-channel clamp exact.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.attack import patch as JPatch
from eval_driving_safety_tpu.cli import patch_attack as JC
from eval_driving_safety_tpu.config import StereoRCNNConfig as JaxCfg
from eval_driving_safety_tpu.models.stereo_rcnn import StereoRCNN as JaxRCNN
from eval_driving_safety_tpu.models.stereo_rcnn import \
    total_attack_loss as jax_total
from eval_driving_safety_tpu_torch.attack import patch as TPatch
from eval_driving_safety_tpu_torch.cli import patch_attack as C
from eval_driving_safety_tpu_torch.cli.predict_and_save import \
    main as predict_main
from eval_driving_safety_tpu_torch.config import (PLACEMENT_BANDS,
                                                   StereoRCNNConfig)
from eval_driving_safety_tpu_torch.data import dataset as TD
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
    StereoRCNN, total_attack_loss)
from eval_driving_safety_tpu_torch.utils.checkpoint import save_checkpoint
from eval_driving_safety_tpu_torch.utils.from_flax import \
    stereo_rcnn_state_dict_from_flax
from test_torch_srcnn_predict import _tiny_pair, kitti_dir
from test_torch_stereo_rcnn import jax_model_draws

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


RADIUS = 4                                  # a 9-px patch at 96 rows
CL = np.array([[70, 120], [60, 230]])
CR = CL + np.array([0, -64])
UNCERT = np.asarray([0.3, -0.2, 0.1, 0.5, -0.4, 0.2], np.float32)
RNG = jax.random.PRNGKey(17)


def test_srcnn_patch_targets_match_jax():
    cfg = StereoRCNNConfig.tiny()
    got = C._srcnn_patch_targets(2, cfg, RADIUS, torch.from_numpy(CL),
                                 torch.from_numpy(CR))
    want = JC._srcnn_patch_targets(2, JaxCfg.tiny(), RADIUS, CL, CR)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    np.testing.assert_array_equal(got["gt_left"][0, 0].numpy(),
                                  [116, 66, 124, 74, 1])
    assert not got["gt_left"][:, 1:].any()


def _bounds():
    means = np.asarray(JaxCfg.tiny().input.pixel_means_bgr, np.float32)
    return -means, 255.0 - means


def _start_patch():
    """A patch half at its channels' bounds (so the step's clamp is
    taken), the rest seeded inside them."""
    lo, hi = _bounds()
    rng = np.random.RandomState(9)
    p = lo + (hi - lo) * rng.rand(2 * RADIUS + 1, 2 * RADIUS + 1, 3)
    p[::2] = np.where(rng.rand(*p[::2].shape) < 0.5, lo, hi)
    return p.astype(np.float32)


def test_srcnn_patch_step_matches_jax():
    """One step of the tiny fp32 model (bridged weights, JAX's sampler
    draws, the same centres, uncert != 0) at the CLI's defaults (alpha
    1e3, eps 0.1): JAX's loss and new patch; the clamp per channel."""
    jcfg, tcfg = JaxCfg.tiny(), StereoRCNNConfig.tiny()
    il, ir = _tiny_pair(2)
    lo, hi = _bounds()
    patch = _start_patch()
    jgt = JC._srcnn_patch_targets(2, jcfg, RADIUS, CL, CR)
    jm = JaxRCNN(jcfg)
    variables = jax.jit(lambda k, a, b: jm.init(
        k, a, b, gt=jax.tree_util.tree_map(lambda x: x[:1], jgt), rng=RNG,
        mode="attack"))(jax.random.PRNGKey(0), il[:1], ir[:1])

    def jstep(p):
        def loss_fn(left, right):
            out = jm.apply(variables, left, right, gt=jgt, rng=RNG,
                           mode="attack")
            return jax_total(out.losses, UNCERT)
        return JPatch.patch_update_step(loss_fn, p, il, ir, CL, CR,
                                        alpha=1e3, eps=0.1, pixel_min=lo,
                                        pixel_max=hi)
    jnew, jl = jax.jit(jstep)(patch)

    model = StereoRCNN(tcfg)
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(variables, model))
    model.requires_grad_(False)
    draws = jax_model_draws(RNG, 2, model.anchors.shape[0],
                            tcfg.post_nms_top_n + tcfg.max_gt_boxes)
    gt = C._srcnn_patch_targets(2, tcfg, RADIUS, CL, CR)
    uncert = torch.from_numpy(UNCERT)

    def loss_fn(left, right):
        out = model(left, right, gt=gt, draws=draws, mode="attack")
        return total_attack_loss(out.losses, uncert)
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    tnew, tl = TPatch.patch_update_step(
        loss_fn, torch.from_numpy(patch), torch.from_numpy(il),
        torch.from_numpy(ir), torch.from_numpy(CL), torch.from_numpy(CR),
        alpha=1e3, eps=0.1, pixel_min=tlo, pixel_max=thi)
    tnew = tnew.numpy()

    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    np.testing.assert_allclose(tnew, np.asarray(jnew), rtol=0, atol=1e-5)
    moved = np.abs(tnew - patch)
    assert moved.max() > 0 and moved.max() <= 0.1 + 1e-5
    # the clamp is per channel, and the step met it in every channel
    for c in range(3):
        assert tnew[..., c].min() >= lo[c] and tnew[..., c].max() <= hi[c]
        assert (tnew[..., c] == lo[c]).any() and (tnew[..., c] == hi[c]).any()
    outside = ~TPatch._mask_np(2 * RADIUS + 1)[..., 0].astype(bool)
    np.testing.assert_array_equal(tnew[outside], patch[outside])


@pytest.fixture(scope="module")
def patch_run(tmp_path_factory):
    """The patch CLI at the tiny config over two frames, 2 epochs of 2
    steps each, at the default save_dir."""
    root = tmp_path_factory.mktemp("srcnn_patch")
    kitti_dir(str(root / "kitti"), ["000001", "000002"])
    cwd = os.getcwd()
    os.chdir(root)
    try:
        C.main(["--data_path", "kitti", "--detector", "srcnn", "--tiny",
                "--device", "cpu", "--epochs", "2"])
    finally:
        os.chdir(cwd)
    return root


def test_cli_srcnn_patch_epochs_bounds_and_rerun(patch_run, capsys):
    """epoch0..2/patch.npy in the (1, 3, 9, 9) layout; each epoch moves
    the patch by at most eps x steps, inside the circle and within the
    per-channel bounds; a rerun from the same epoch0 writes the same
    bytes."""
    a = patch_run / "srcnn_patch_ratio_0.1"
    lo, hi = _bounds()
    outside = ~TPatch._mask_np(2 * RADIUS + 1)[..., 0].astype(bool)
    patches = []
    for e in range(3):
        raw = np.load(a / f"epoch{e}" / "patch.npy")
        assert raw.shape == (1, 3, 9, 9) and raw.dtype == np.float32
        patches.append(raw[0].transpose(1, 2, 0))
    for e in (1, 2):
        change = np.abs(patches[e] - patches[e - 1])
        assert 0 < change.max() <= 0.1 * 2 * 2 + 1e-5
        assert not change[outside].any()
        assert (patches[e] >= lo).all() and (patches[e] <= hi).all()
    b = patch_run / "rerun"
    shutil.copytree(a / "epoch0", b / "epoch0")
    C.main(["--data_path", str(patch_run / "kitti"), "--detector", "srcnn",
            "--tiny", "--device", "cpu", "--epochs", "2", "--save_dir",
            str(b)])
    out = capsys.readouterr().out
    assert "patch dim 9 (radius 4)" in out and out.count("avg loss") == 2
    for e in (1, 2):
        rel = os.path.join(f"epoch{e}", "patch.npy")
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_cli_srcnn_patch_reads_a_checkpoints_uncert(patch_run, capsys):
    """A checkpoint's uncert weights the loss: the same weights with and
    without it give other losses (one step on one frame each)."""
    cfg = StereoRCNNConfig.tiny()
    sd = StereoRCNN(cfg).init_weights(seed=0).state_dict()
    save_checkpoint(str(patch_run / "ck"),
                    {"params": sd, "uncert": torch.from_numpy(UNCERT)})
    kitti_dir(str(patch_run / "kitti1"), ["000001"])
    common = ["--data_path", str(patch_run / "kitti1"), "--detector",
              "srcnn", "--tiny", "--device", "cpu", "--epochs", "1",
              "--iters", "1"]
    C.main(common + ["--save_dir", str(patch_run / "u"), "--ckpt",
                     str(patch_run / "ck")])
    out = capsys.readouterr().out
    assert "using checkpoint uncert" in out
    loss_u = out.split("avg loss")[-1]
    C.main(common + ["--save_dir", str(patch_run / "n")])
    loss_n = capsys.readouterr().out.split("avg loss")[-1]
    assert loss_u != loss_n


@pytest.mark.parametrize("mode", sorted(PLACEMENT_BANDS))
def test_cli_predict_with_the_srcnn_patch(patch_run, mode):
    """predict --detector srcnn with the trained patch in each placement:
    the saved input frame is the ingested frame with the patch
    composited at the centres the seed draws, in the mode's band."""
    patch_npy = patch_run / "srcnn_patch_ratio_0.1" / "epoch2" / "patch.npy"
    out = patch_run / f"pred_{mode}"
    predict_main(["--data_path", str(patch_run / "kitti"), "--detector",
                  "srcnn", "--tiny", "--device", "cpu", "--result_dir",
                  str(out), "--patch_npy", str(patch_npy), "--patch_mode",
                  mode, "--seed", "3", "--save_input_dir",
                  str(out / "inputs")])
    assert sorted(os.listdir(out / "data")) == ["000001.txt", "000002.txt"]
    cfg = StereoRCNNConfig.tiny()
    ds = TD.KittiStereoDataset(str(patch_run / "kitti"))
    b = TD.prepare_srcnn_batch_u8([ds.get(0)], cfg.input)
    weights = {k: torch.from_numpy(b[k])
               for k in ("ih", "iw", "den_h", "den_w", "wmask", "c")}
    clean = TD.srcnn_clean01_device(
        weights, torch.from_numpy(b["im_left_u8"]))[0].numpy() * 255.0 \
        - np.asarray(cfg.input.pixel_means_bgr, np.float32)
    cl, _ = TPatch.sample_patch_centers(
        torch.Generator().manual_seed(3), 1, 96, 320, RADIUS,
        col_band=PLACEMENT_BANDS[mode])
    want = TPatch.composite_patch_batch(
        torch.from_numpy(clean[None]), TPatch.load_patch(str(patch_npy)),
        cl)[0].numpy()
    rgb01 = TK.srcnn_to_rgb01(want, cfg.input.pixel_means_bgr)
    saved = TK.load_image_u8(str(out / "inputs" / "image_2" / "000001.png"))
    np.testing.assert_array_equal(
        saved, np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8))
    cols = np.nonzero(np.abs(want - clean).max(-1).max(0) > 0)[0]
    lo, hi = PLACEMENT_BANDS[mode]
    assert cols.size and int(320 * lo) - RADIUS <= cols.min() \
        and cols.max() <= int(320 * hi) + RADIUS
