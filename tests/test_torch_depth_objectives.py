"""The DSGN attack under the depth objectives (attack/objectives.py
`depth_divergence`, `depth_shift`) and the attack CLI's `--objective`,
`--depth_dir` and `--debug_nans`, on the CPU.

(a) The first two PGD iterations of the tiny DSGN in fp32, on weights
bridged from the JAX package's init and a seeded depth map, through each
package's attack/pgd.py and objectives: the losses within 1e-4 relative,
the first step's image gradients within 1e-3 x the largest
(tests/test_torch_dsgn.py's tolerances for the loss of a depth map's mean
and for input gradients).

(b) The attack CLI at --scale tiny: under each depth objective with
--depth_dir, the sweep's layout, a rerun writing the same bytes and the
losses ascending; without --depth_dir the objectives see no valid depth
(zeros, as the JAX CLI passes), so the loss and its gradient are 0 and
every iterate is the clean frame; --debug_nans (autograd's anomaly mode)
writes the bytes of the run without it. A test that compares two runs'
bytes runs torch on one intra-op thread (`one_thread`)."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.attack import objectives as JO
from eval_driving_safety_tpu.attack.pgd import pgd_attack as jax_pgd
from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
from eval_driving_safety_tpu_torch.attack import objectives as TO
from eval_driving_safety_tpu_torch.attack.pgd import pgd_attack
from eval_driving_safety_tpu_torch.cli.pgd_attack import main
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax
from test_torch_cli import _kitti_dir, _sweep_files
from test_torch_dsgn import MEAN255, STD255, _inputs

OBJECTIVES = ("depth_divergence", "depth_shift")
SHIFT_M = 5.0
PGD = dict(alpha=1.0, eps=76.5, clip_min=0.0, clip_max=255.0)


def _objective(module, name, out, depth, cfg):
    if name == "depth_shift":
        return module.depth_shift(out, depth, SHIFT_M, cfg)
    return module.depth_divergence(out, depth, cfg)


@pytest.fixture(scope="module")
def models():
    """The JAX tiny DSGN (fp32, its default library paths) with its init,
    and the port's DSGN with the same weights."""
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    il, ir, calib = _inputs()[:3]
    jm = JaxDSGN(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), (il - MEAN255) / STD255,
                              (ir - MEAN255) / STD255, *calib)
    model = DSGN(tcfg)
    model.load_state_dict(dsgn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, jm, params, tcfg, model.requires_grad_(False)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_depth_objective_attack_matches_jax(models, objective):
    """Two PGD iterations under the objective in each package: the
    losses, and the image gradients of the first step."""
    jcfg, jm, params, tcfg, model = models
    il, ir, calib, depth = _inputs()[:4]
    assert ((depth > tcfg.min_depth) & (depth <= tcfg.max_depth)).any()

    def jloss(l255, r255):
        out = jm.apply(params, (l255 - MEAN255) / STD255,
                       (r255 - MEAN255) / STD255, *calib)
        return _objective(JO, objective, out, depth, jcfg)
    jres = jax.jit(lambda l, r: jax_pgd(jloss, l, r, num_iters=2, **PGD))(
        jnp.asarray(il), jnp.asarray(ir))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(il),
                                                      jnp.asarray(ir))

    m255, s255 = torch.from_numpy(MEAN255), torch.from_numpy(STD255)
    tcalib = [torch.from_numpy(c) for c in calib]
    tdepth = torch.from_numpy(depth)

    def tloss(l255, r255):
        out = model((l255 - m255) / s255, (r255 - m255) / s255, *tcalib)
        return _objective(TO, objective, out, tdepth, tcfg)
    til, tir = torch.from_numpy(il), torch.from_numpy(ir)
    res = pgd_attack(tloss, til, tir, num_iters=2, **PGD)
    vl, vr = (x.clone().requires_grad_(True) for x in (til, tir))
    grads = torch.autograd.grad(tloss(vl, vr), (vl, vr))

    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses),
                               rtol=1e-4)
    for got, want in zip(grads, jgrads):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())


IDS = ["000001", "000002"]
ITERS = 2


@pytest.fixture
def one_thread():
    """One intra-op thread for the CLI runs whose bytes a rerun must
    repeat. On several CPU threads oneDNN's bf16 convs do not always give
    the same bits from run to run (one bf16 step apart, enough to flip a
    gradient's sign: ROADMAP.md §C, known differences); on the card the
    CLIs' deterministic mode makes reruns repeat bit for bit
    (chip_smoke.py phase 18)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames_and_depth(tmp_path):
    """test_torch_cli's two 90 x 300 frames, and a seeded depth map for
    each (half the pixels at 3-50 m)."""
    data = str(tmp_path / "kitti")
    _kitti_dir(data, IDS)
    depth = tmp_path / "depth"
    depth.mkdir()
    rng = np.random.RandomState(4)
    for fid in IDS:
        d = np.where(rng.rand(90, 300) < 0.5, rng.uniform(3.0, 50.0,
                                                          (90, 300)), 0.0)
        np.save(depth / (fid + ".npy"), d.astype(np.float32))
    return data, str(depth)


def _attack(data, out, capsys, *flags, iters=ITERS):
    """Run the attack CLI at --scale tiny on the CPU into `out`; returns
    the losses it printed, one list a frame."""
    main(["--data_path", data, "--detector", "dsgn", "--scale", "tiny",
          "--iter", str(iters), "--device", "cpu", "--out_prefix",
          os.path.join(out, "dsgn_pgd"), *flags])
    return [[float(v) for v in m.split(",")] for m in re.findall(
        r"losses \[([^\]]*)\]", capsys.readouterr().out)]


def _same_bytes(a, b):
    files = _sweep_files(a)
    assert files == _sweep_files(b)
    for rel in files:
        assert open(os.path.join(a, rel), "rb").read() == \
            open(os.path.join(b, rel), "rb").read(), rel
    return files


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_cli_depth_objective_with_depth_dir(tmp_path, capsys, one_thread,
                                            objective):
    """--objective with --depth_dir: every iteration's pair written, the
    losses finite and ascending, the attacked frames moved within eps,
    and a rerun writing the same bytes."""
    data, depth = _frames_and_depth(tmp_path)
    flags = ["--objective", objective, "--depth_dir", depth,
             "--depth_shift_m", str(SHIFT_M)]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    losses = _attack(data, a, capsys, *flags)
    _attack(data, b, capsys, *flags)
    files = _same_bytes(a, b)
    assert files == sorted(os.path.join(f"dsgn_pgd_iters_{k}", side,
                                        fid + ".png")
                           for k in range(ITERS + 1)
                           for side in ("image_2", "image_3")
                           for fid in IDS)
    assert len(losses) == len(IDS)
    for frame in losses:
        assert len(frame) == ITERS and np.isfinite(frame).all()
        assert frame[-1] > frame[0], losses
    for fid in IDS:
        clean = K.load_image_u8(os.path.join(data, "image_2", fid + ".png"))
        adv = K.load_image_u8(os.path.join(a, f"dsgn_pgd_iters_{ITERS}",
                                           "image_2", fid + ".png"))
        diff = np.abs(adv.astype(int) - clean.astype(int)).max()
        assert 0 < diff <= 77


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_cli_depth_objective_without_depth_dir_leaves_the_frames(
        tmp_path, capsys, objective):
    """Without --depth_dir no pixel has a valid depth: the loss is 0, its
    gradient 0, and every iteration writes the clean frames' bytes."""
    data, _ = _frames_and_depth(tmp_path)
    out = str(tmp_path / "a")
    losses = _attack(data, out, capsys, "--objective", objective)
    assert losses == [[0.0] * ITERS] * len(IDS)
    for fid in IDS:
        for side in ("image_2", "image_3"):
            clean = K.load_image_u8(os.path.join(data, side, fid + ".png"))
            for k in range(ITERS + 1):
                path = os.path.join(out, f"dsgn_pgd_iters_{k}", side,
                                    fid + ".png")
                assert np.array_equal(K.load_image_u8(path), clean), path


def test_cli_debug_nans_writes_the_same_bytes(tmp_path, capsys,
                                              one_thread):
    """--debug_nans runs autograd in anomaly mode, which checks every
    backward's outputs for NaN: the sweep's bytes and losses are those of
    the run without it."""
    data, _ = _frames_and_depth(tmp_path)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    losses = _attack(data, a, capsys, iters=1)
    assert not torch.is_anomaly_enabled()
    assert _attack(data, b, capsys, "--debug_nans", iters=1) == losses
    assert not torch.is_anomaly_enabled()
    _same_bytes(a, b)
