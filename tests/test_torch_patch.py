"""The port's DSGN patch attack against the JAX package on CPU: the
training step, the resized patch ingest, the patch files, and the CLI
end to end.

Tolerances: on a quadratic loss the step is the same few fp32
operations in both packages (1e-6). On the tiny DSGN (fp32, bridged
weights, injected centres) the loss agrees within 1e-4 relative and the
patch gradient within 1e-3 x its largest magnitude, the tolerances of
the model's input gradients (tests/test_torch_dsgn.py); the new patch is
held where the clamp decides it: pixels whose step is clamped move by
exactly eps in both, the others by 0.5 * alpha * g, within the
gradient's tolerance times 0.5 * alpha. Pixels whose |0.5 * alpha * g|
lies within 1e-3 * eps of eps are left out, since a gradient within its
tolerance may fall on either side of the clamp there.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.attack import patch as JP
from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.config import PatchConfig as JaxPatchConfig
from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
from eval_driving_safety_tpu.models.rpn3d_loss import \
    dsgn_total_loss as jax_total_loss
from eval_driving_safety_tpu_torch.attack import patch as TP
from eval_driving_safety_tpu_torch.cli import patch_attack as C
from eval_driving_safety_tpu_torch.config import DSGNConfig, PatchConfig
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.models.rpn3d_loss import dsgn_total_loss
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax

MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)
CALIB_VALUES = (180.0, 0.54, 160.0, 48.0)


def _mask(d):
    return np.asarray(TP.circular_mask(d))[..., 0] > 0


def test_patch_config_matches_jax():
    assert dataclasses.asdict(PatchConfig()) == \
        dataclasses.asdict(JaxPatchConfig())


# centres of a 32 x 48 image and an 11-pixel patch (r = 5): inside, the
# right view partly past the left edge, and a left view fully off the
# image (no visible pixel: its composite contributes no gradient)
QUAD_LEFT = [[12, 20], [20, 3], [-9, 30]]
QUAD_RIGHT = [[12, 12], [20, -3], [20, 47]]


@pytest.mark.parametrize("clip", [None, (0.1, 0.7)])
def test_patch_step_on_a_quadratic_loss_equals_jax(clip):
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 32, 48, 3).astype(np.float32)
    patch = rng.rand(11, 11, 3).astype(np.float32)
    w = rng.rand(32, 48, 3).astype(np.float32)
    cl, cr = np.array(QUAD_LEFT), np.array(QUAD_RIGHT)
    kw = dict(alpha=1.0, eps=0.05)
    if clip:
        kw.update(pixel_min=clip[0], pixel_max=clip[1])

    def jloss(l, r):
        return (w * l ** 2).sum() + (r ** 2).sum()

    def tloss(l, r):
        return (torch.from_numpy(w) * l ** 2).sum() + (r ** 2).sum()

    jp, jl = JP.patch_update_step(jloss, jnp.asarray(patch), jnp.asarray(
        imgs), jnp.asarray(imgs), jnp.asarray(cl), jnp.asarray(cr), **kw)
    tp, tl = TP.patch_update_step(tloss, torch.from_numpy(patch),
                                  torch.from_numpy(imgs),
                                  torch.from_numpy(imgs), cl, cr, **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert not tp.requires_grad
    outside = ~_mask(11)
    if clip is None:
        assert np.array_equal(tp.numpy()[outside], patch[outside])
        assert np.abs(tp.numpy() - patch).max() <= 0.05 + 1e-7


def test_patch_step_gradient_is_zero_for_centres_off_the_image():
    patch = torch.rand(11, 11, 3, generator=torch.Generator().manual_seed(1))
    imgs = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(2))
    off = np.array([[-6, 20], [10, 53]])       # past the top; past the right
    new, loss = TP.patch_update_step(lambda l, r: (l ** 2).sum()
                                     + (r ** 2).sum(), patch, imgs, imgs,
                                     off, off, alpha=1.0, eps=0.05)
    assert torch.equal(new, patch)
    np.testing.assert_allclose(float(loss), float(2 * (imgs ** 2).sum()),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_pair():
    """Tiny fp32 DSGN weights (JAX init, bridged), two frames, the
    ghost-car targets and injected centres: the second image's right
    view lies partly past the left edge."""
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    rng = np.random.RandomState(3)
    il = rng.randint(0, 256, (2, 96, 320, 3)).astype(np.uint8)
    ir = np.clip(np.roll(il.astype(int), -6, axis=2)
                 + rng.randint(-8, 9, il.shape), 0, 255).astype(np.uint8)
    calib = [np.full((2,), v, np.float32) for v in CALIB_VALUES]
    jm = JaxDSGN(jcfg)
    norm = ((il[:1] / 255.0 - MEAN) / STD).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), norm, norm,
                              *(c[:1] for c in calib))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = DSGN(tcfg)
    model.load_state_dict(dsgn_state_dict_from_flax(params))
    model.requires_grad_(False)
    d = TP.patch_dim_for(96, 0.2)
    patch = rng.rand(d, d, 3).astype(np.float32)
    cl = np.array([[60, 150], [70, 40]])
    cr = cl + np.array([0, -64])
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, params=params, model=model,
                il=il, ir=ir, calib=calib, patch=patch, cl=cl, cr=cr)


def test_ghost_car_targets_equal_jax():
    from eval_driving_safety_tpu.cli.patch_attack import ghost_car_targets
    jb, jn = ghost_car_targets(2, JaxPatchConfig())
    tb, tn = C.ghost_car_targets(2, PatchConfig())
    assert tb.shape == (2, 16, 8)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tn.numpy(), np.asarray(jn))


def test_patch_step_on_the_tiny_dsgn_matches_jax(tiny_pair):
    t = tiny_pair
    alpha, eps = 1e3, 8 / 255
    jcfg, tcfg = t["jcfg"], t["tcfg"]
    jb, jn = (np.asarray(a) for a in C.ghost_car_targets(2, PatchConfig()))
    il01, ir01 = (a.astype(np.float32) / 255.0 for a in (t["il"], t["ir"]))
    depth = np.zeros(il01.shape[:3], np.float32)

    def jloss(l, r):
        out = t["jm"].apply(t["params"], (l - MEAN) / STD, (r - MEAN) / STD,
                            *t["calib"])
        return jax_total_loss(out, depth, jb, jn, jcfg)[0]

    def jf(p):
        return jloss(JP.composite_patch_batch(il01, p, t["cl"]),
                     JP.composite_patch_batch(ir01, p, t["cr"]))

    jl, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(t["patch"]))
    jg = np.asarray(jg)
    jnew = np.asarray(t["patch"] - np.clip(0.5 * alpha * jg, -eps, eps))

    mean, std = torch.from_numpy(MEAN), torch.from_numpy(STD)
    calib = [torch.from_numpy(c) for c in t["calib"]]

    def tloss(l, r):
        out = t["model"]((l - mean) / std, (r - mean) / std, *calib)
        return dsgn_total_loss(out, torch.from_numpy(depth),
                               torch.from_numpy(jb), torch.from_numpy(jn),
                               tcfg)[0]

    til, tir = torch.from_numpy(il01), torch.from_numpy(ir01)
    p = torch.from_numpy(t["patch"]).requires_grad_(True)
    (tg,) = torch.autograd.grad(tloss(TP.composite_patch_batch(
        til, p, t["cl"]), TP.composite_patch_batch(tir, p, t["cr"])), p)
    tnew, tl = TP.patch_update_step(tloss, torch.from_numpy(t["patch"]),
                                    til, tir, t["cl"], t["cr"], alpha=alpha,
                                    eps=eps)
    tg, tnew = tg.numpy(), tnew.numpy()

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    gmax = np.abs(jg).max()
    assert gmax > 0
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-3 * gmax)
    step = np.abs(0.5 * alpha * jg)
    clamped = step >= eps * (1 + 1e-3)
    free = step <= eps * (1 - 1e-3)
    assert clamped.any() and free.any()
    assert np.array_equal(tnew[clamped], jnew[clamped])
    np.testing.assert_allclose(tnew[free], jnew[free], rtol=0,
                               atol=0.5 * alpha * 1e-3 * gmax)
    outside = ~_mask(t["patch"].shape[0])
    assert np.array_equal(tnew[outside], t["patch"][outside])
    assert not tg[outside].any()


def _cv2_inter_linear(img: np.ndarray, out: int) -> np.ndarray:
    """Independent numpy oracle for cv2.resize(..., INTER_LINEAR) on
    float32 input: 2-tap bilinear at half-pixel centers, NO antialiasing,
    with cv2's border rule (sy<0 -> row 0 weight 1; sy>=h-1 -> row h-1).
    (A copy of tests/test_attack.py's oracle.)"""
    h, w, c = img.shape

    def taps(n_src, n_dst):
        f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
        i0 = np.floor(f).astype(np.int64)
        frac = f - i0
        frac[i0 < 0] = 0.0
        i0 = np.clip(i0, 0, n_src - 1)
        i1 = np.minimum(i0 + 1, n_src - 1)
        return i0, i1, frac.astype(np.float32)

    y0, y1, fy = taps(h, out)
    x0, x1, fx = taps(w, out)
    rows0 = img[y0][:, x0] * (1 - fx)[None, :, None] + \
        img[y0][:, x1] * fx[None, :, None]
    rows1 = img[y1][:, x0] * (1 - fx)[None, :, None] + \
        img[y1][:, x1] * fx[None, :, None]
    return rows0 * (1 - fy)[:, None, None] + rows1 * fy[:, None, None]


@pytest.mark.parametrize("src,dst", [(61, 77), (77, 61)])
def test_load_patch_resize_matches_jax_and_cv2(tmp_path, src, dst):
    rng = np.random.RandomState(7)
    patch = rng.rand(src, src, 3).astype(np.float32)
    path = str(tmp_path / "patch.npy")
    TP.save_patch(path, torch.from_numpy(patch))
    got = TP.load_patch(path, resize_to=dst).numpy()
    assert got.shape == (dst, dst, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(JP.load_patch(
        path, resize_to=dst)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, _cv2_inter_linear(patch, dst), rtol=0,
                               atol=1e-5)


def test_init_patch_fresh_and_resumed(tmp_path):
    d, r, p = TP.init_patch(384, 0.2, str(tmp_path))
    assert (d, r) == (77, 38) and p.shape == (77, 77, 3)
    assert not p.any()
    raw = np.load(tmp_path / "epoch0" / "patch.npy")
    assert raw.shape == (1, 3, 77, 77) and not raw.any()
    # a patch left in epoch0 is the start; one of another size is resized
    rng = np.random.RandomState(2)
    for n in (77, 61):
        start = rng.rand(n, n, 3).astype(np.float32)
        TP.save_patch(str(tmp_path / "epoch0" / "patch.npy"),
                      torch.from_numpy(start))
        d2, r2, p2 = TP.init_patch(384, 0.2, str(tmp_path))
        jd, jr, jp = JP.init_patch(384, 0.2, str(tmp_path))
        assert (d2, r2) == (jd, jr) == (77, 38)
        np.testing.assert_allclose(p2.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)
        if n == 77:
            assert np.array_equal(p2.numpy(), start)


def test_patch_files_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(4)
    patch = rng.rand(19, 19, 3).astype(np.float32)
    JP.save_patch(str(tmp_path / "jax.npy"), jnp.asarray(patch))
    TP.save_patch(str(tmp_path / "port.npy"), torch.from_numpy(patch))
    assert np.array_equal(np.load(tmp_path / "jax.npy"),
                          np.load(tmp_path / "port.npy"))
    assert np.array_equal(TP.load_patch(str(tmp_path / "jax.npy")).numpy(),
                          patch)
    assert np.array_equal(np.asarray(JP.load_patch(str(tmp_path /
                                                       "port.npy"))), patch)


CALIB = ("P2: 180.0 0.0 160.0 11.2 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n"
         "P3: 180.0 0.0 160.0 -86.0 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n")


def _kitti_dir(root, ids, hw=(90, 300)):
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib"):
        os.makedirs(os.path.join(root, sub))
    for fid in ids:
        left = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        TK.write_png(os.path.join(root, "image_2", fid + ".png"), left)
        TK.write_png(os.path.join(root, "image_3", fid + ".png"),
                     np.roll(left, -5, axis=1))
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)


def test_cli_trains_writes_the_reference_layout_and_resumes(tmp_path,
                                                            capsys):
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ["000001", "000002"])
    iters, batches, eps = 2, 2, 8 / 255
    common = ["--data_path", data, "--detector", "dsgn", "--scale", "tiny",
              "--device", "cpu", "--epochs", "2", "--iters", str(iters)]
    a = tmp_path / "a"
    C.main(common + ["--save_dir", str(a)])
    out = capsys.readouterr().out
    assert "patch dim 19 (radius 9)" in out
    assert out.count("avg loss") == 2
    d = TP.patch_dim_for(96, 0.2)
    outside = ~_mask(d)
    patches = []
    for e in range(3):
        raw = np.load(a / f"epoch{e}" / "patch.npy")
        assert raw.shape == (1, 3, d, d) and raw.dtype == np.float32
        assert np.isfinite(raw).all()
        patches.append(raw[0].transpose(1, 2, 0))
    for e in (1, 2):
        change = np.abs(patches[e] - patches[e - 1])
        assert 0 < change.max() <= eps * iters * batches + 1e-6
        assert not change[outside].any()
    # a rerun from the same epoch0 writes the same files
    b = tmp_path / "b"
    shutil.copytree(a / "epoch0", b / "epoch0")
    C.main(common + ["--save_dir", str(b)])
    for e in (1, 2):
        rel = os.path.join(f"epoch{e}", "patch.npy")
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_cli_refuses_srcnn(tmp_path):
    with pytest.raises(SystemExit, match="items 9 and 11"):
        C.main(["--data_path", str(tmp_path), "--detector", "srcnn"])


def test_cli_takes_every_flag_of_the_jax_cli():
    """Every option of the JAX CLI's parser parses here, to the same
    defaults."""
    import sys
    from eval_driving_safety_tpu.cli import patch_attack as J
    argv = sys.argv
    sys.argv = ["patch_attack", "--data_path", "d"]
    try:
        jax_args = vars(J.parse_args())
    finally:
        sys.argv = argv
    port_args = vars(C.parse_args(["--data_path", "d"]))
    assert set(jax_args) <= set(port_args)
    assert {k: port_args[k] for k in jax_args} == jax_args
