"""The port's DSGN checkpoint-compat assembly and its import of the
upstream checkpoint layout, against the JAX package on CPU.

The JAX package's `import_dsgn` defines the upstream key layout (and
tests/test_dsgn_compat.py's torch replica pins it), so a state dict of
the port's compat module must import there with no key left over, and
here too. Parity runs the tiny arch at the tiny DSGN geometry in fp32 on
the same weights: outputs within 1e-4 x their largest magnitude, input
gradients within 1e-3 x theirs, the tolerances of the fast model's
parity (tests/test_torch_dsgn.py; the JAX side runs its own formulation
of the 3D convs, three depth-sliced 2D convs, and of the plane sweep,
an einsum). `spp_pools` is set after the import: pool windows leave no
trace in a state dict, and the import keeps the upstream windows.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.models import dsgn_compat as JC
from eval_driving_safety_tpu.models.rpn3d_loss import \
    dsgn_total_loss as jax_total_loss
from eval_driving_safety_tpu.utils import torch_import as JI
from eval_driving_safety_tpu_torch.cli.common import make_dsgn_model
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.models import dsgn_compat as TC
from eval_driving_safety_tpu_torch.models.rpn3d_loss import dsgn_total_loss
from eval_driving_safety_tpu_torch.utils import torch_import as TI

TINY = TC.DSGNCompatArch.tiny()
CALIB_VALUES = (180.0, 0.54, 160.0, 48.0)


def _tcfg():
    return dataclasses.replace(DSGNConfig.tiny(), dtype="float32")


def _jcfg():
    return dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32")


def _random_weights(model, seed):
    """Seeded weights with every BatchNorm's statistics, every norm's
    scale and shift and every bias drawn at random, as a trained
    checkpoint has them."""
    model.init_weights(seed)
    g = torch.Generator().manual_seed(seed + 1)
    rand = lambda t: torch.randn(t.shape, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TC.BatchNorm):
                m.running_mean.copy_(rand(m.running_mean) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) + 0.5)
            if isinstance(m, (TC.BatchNorm, TC.GroupNorm)):
                m.weight.copy_(rand(m.weight) * 0.2 + 1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.add_(rand(m.bias) * 0.1)
    return model


def _upstream_sd(cfg=None, arch=TINY, seed=0):
    """The compat module's weights in the published layout: DataParallel's
    `module.` prefix and BatchNorm's `num_batches_tracked` counters."""
    model = _random_weights(TC.DSGNCompat(cfg or _tcfg(), arch), seed)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    return model, sd


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("arch", [TINY, TC.DSGNCompatArch()],
                         ids=["tiny", "upstream"])
def test_key_layout_imports_in_both_packages(arch):
    cfg = dataclasses.replace(DSGNConfig(), dtype="float32")
    model, sd = _upstream_sd(cfg, arch)
    jax_imported = JI.import_dsgn(_np_sd(sd))
    assert jax_imported["unmapped"] == []
    imported = TI.import_dsgn(sd)
    assert imported["unmapped"] == []
    assert set(imported["state_dict"]) == set(model.state_dict())
    assert dataclasses.asdict(imported["arch"]) == \
        dataclasses.asdict(jax_imported["arch"])
    assert dataclasses.replace(imported["arch"],
                               spp_pools=arch.spp_pools) == arch


def test_torch_replica_of_the_upstream_graph_loads_as_it_is():
    """tests/test_dsgn_compat.py's torch replica of the upstream module
    graph (nn.Conv*, nn.BatchNorm*, nn.GroupNorm under the upstream
    names) has exactly the compat module's keys and shapes."""
    from test_dsgn_compat import TDSGNUpstream
    cfg = _tcfg()
    sd = TDSGNUpstream(TINY, cfg.num_voxels_y).state_dict()
    imported = TI.import_dsgn({f"module.{k}": v for k, v in sd.items()})
    assert imported["unmapped"] == []
    want = TC.DSGNCompat(cfg, TINY).state_dict()
    got = imported["state_dict"]
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_convbn_blocks_nested_one_level_off_import_in_both_packages():
    """A convbn at one Sequential level deeper (rpn3d_conv, dres0.0) or
    shallower (a BasicBlock's conv1, hg1.conv1) than the module has it
    imports with no key left over, into the same tensors."""
    model, sd = _upstream_sd()
    moved = {"module.rpn3d_conv.": "module.rpn3d_conv.0.",
             "module.dres0.0.": "module.dres0.0.0.",
             "module.feature_extraction.layer1.0.conv1.0.":
                 "module.feature_extraction.layer1.0.conv1.",
             "module.hg1.conv1.0.": "module.hg1.conv1."}
    renested = {}
    for k, v in sd.items():
        for old, new in moved.items():
            if k.startswith(old):
                k = new + k[len(old):]
                break
        renested[k] = v
    assert set(renested) != set(sd)
    assert JI.import_dsgn(_np_sd(renested))["unmapped"] == []
    imported = TI.import_dsgn(renested)
    assert imported["unmapped"] == []
    want = model.state_dict()
    assert set(imported["state_dict"]) == set(want)
    assert all(torch.equal(imported["state_dict"][k], v)
               for k, v in want.items())


def test_unknown_keys_are_reported():
    _, sd = _upstream_sd()
    sd["module.extra_head.weight"] = torch.zeros(3)
    assert TI.import_dsgn(sd)["unmapped"] == ["extra_head.weight"]


@pytest.fixture(scope="module")
def parity_pair():
    """One set of weights in both packages: the port's compat module's
    state dict, imported into the JAX compat model."""
    model, sd = _upstream_sd(seed=3)
    imported = TI.import_dsgn(sd)
    arch = dataclasses.replace(imported["arch"], spp_pools=TINY.spp_pools)
    tm = TC.DSGNCompat(_tcfg(), arch)
    tm.load_state_dict(imported["state_dict"])
    tm.requires_grad_(False)
    jimp = JI.import_dsgn(_np_sd(sd))
    jarch = dataclasses.replace(jimp["arch"], spp_pools=TINY.spp_pools)
    return dict(tm=tm, jparams=jimp["params"], jarch=jarch)


def _frames(b=1):
    rng = np.random.RandomState(6)
    il = rng.rand(b, 96, 320, 3).astype(np.float32) * 4 - 2
    ir = np.roll(il, -6, axis=2) + rng.randn(*il.shape).astype(
        np.float32) * 0.1
    calib = [np.full((b,), v, np.float32) for v in CALIB_VALUES]
    return il, ir, calib


def _close(got, want, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=floor * np.abs(want).max())


def test_feature_extraction_matches_jax(parity_pair):
    x = _frames()[0]
    want = JC.CompatFeatureExtraction(parity_pair["jarch"]).apply(
        {"params": parity_pair["jparams"]["feat"]}, x)
    got = parity_pair["tm"].feature_extraction(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-4)


def test_hourglass_matches_jax(parity_pair):
    x = np.random.RandomState(1).randn(1, 8, 8, 12, TINY.cv_channels)
    x = x.astype(np.float32)
    want = JC.CompatHourglass3D(TINY.hg_channels).apply(
        {"params": parity_pair["jparams"]["hg1"]}, x)
    got = parity_pair["tm"].hg1(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-4)


def test_bev_head_matches_jax(parity_pair):
    from flax import linen as nn
    p = parity_pair["jparams"]
    x = np.random.RandomState(2).randn(1, 6, 10, TINY.bev_channels)
    x = x.astype(np.float32)
    ct = bt = jnp.asarray(x)
    for i in range(TINY.tower_convs):
        ct = JC.CompatTowerBlock(TINY.bev_channels, TINY.gn_groups).apply(
            {"params": p[f"cls_tower_{i}"]}, ct)
        bt = JC.CompatTowerBlock(TINY.bev_channels, TINY.gn_groups).apply(
            {"params": p[f"bbox_tower_{i}"]}, bt)
    want = (nn.Conv(TINY.num_classes, (3, 3), padding="SAME").apply(
                {"params": p["cls_logits"]}, ct),
            nn.Conv(8, (3, 3), padding="SAME").apply(
                {"params": p["bbox_pred"]}, bt),
            nn.Conv(1, (3, 3), padding="SAME").apply(
                {"params": p["centerness"]}, bt)[..., 0])
    got = parity_pair["tm"].rpn3d(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4)


def test_bev_collapse_is_channel_outer():
    v = torch.arange(2 * 3 * 4 * 5 * 6.0).reshape(2, 3, 4, 5, 6)
    got = TC.bev_collapse(v).numpy()
    want = np.asarray(JC.bev_collapse(jnp.asarray(v.numpy())))
    assert np.array_equal(got, want)
    # channel c * Y + y holds voxel channel c at height y
    assert np.array_equal(got[..., 2 * 4 + 1], v[:, :, 1, :, 2].numpy())


@pytest.fixture(scope="module")
def model_pair(parity_pair):
    """The whole compat model in both packages: outputs, the attack's
    loss and its input gradients on one frame pair."""
    il, ir, calib = _frames()
    jm = JC.DSGNCompat(_jcfg(), parity_pair["jarch"])
    jparams = {"params": parity_pair["jparams"]}
    boxes = np.zeros((1, 4, 8), np.float32)
    boxes[0, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    nb = np.array([1], np.int32)
    depth = np.where(np.random.RandomState(3).rand(1, 96, 320) < 0.5, 20.0,
                     0.0).astype(np.float32)

    def jloss(l, r):
        out = jm.apply(jparams, l, r, *calib)
        return jax_total_loss(out, depth, boxes, nb, _jcfg())[0]

    jout = jax.jit(lambda l, r: jm.apply(jparams, l, r, *calib))(il, ir)
    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(il, ir)
    tm = parity_pair["tm"]
    tl_in, tr_in = (torch.from_numpy(a).requires_grad_(True)
                    for a in (il, ir))
    tcal = [torch.from_numpy(c) for c in calib]
    tout = tm(tl_in, tr_in, *tcal)
    tl, _ = dsgn_total_loss(tout, torch.from_numpy(depth),
                            torch.from_numpy(boxes),
                            torch.from_numpy(nb.astype(np.int64)), _tcfg())
    tg = torch.autograd.grad(tl, (tl_in, tr_in))
    return dict(jout=jout, jl=jl, jg=jg, tout=tout, tl=tl, tg=tg)


def test_compat_model_outputs_match_jax(model_pair):
    jout, tout = model_pair["jout"], model_pair["tout"]
    assert len(tout["depth_preds"]) == len(jout["depth_preds"]) == 1
    _close(tout["depth_preds"][0].detach().numpy(), jout["depth_preds"][0],
           1e-4)
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        _close(tout[k].detach().numpy(), jout[k], 1e-4)


def test_compat_attack_loss_and_input_gradients_match_jax(model_pair):
    np.testing.assert_allclose(float(model_pair["tl"].detach()),
                               float(model_pair["jl"]), rtol=1e-4)
    for g, w in zip(model_pair["tg"], model_pair["jg"]):
        assert np.abs(np.asarray(w)).max() > 0
        _close(g.numpy(), w, 1e-3)


def test_load_dsgn_checkpoint_checks_the_bev_width(tmp_path):
    _, sd = _upstream_sd()
    path = str(tmp_path / "dsgn.tar")
    torch.save({"state_dict": sd}, path)
    model, imported = TI.load_dsgn_checkpoint(path, _tcfg())
    assert isinstance(model, TC.DSGNCompat) and imported["unmapped"] == []
    wrong = dataclasses.replace(_tcfg(), num_voxels_y=5)
    with pytest.raises(ValueError, match="num_voxels_y to 4"):
        TI.load_dsgn_checkpoint(path, wrong)


def test_make_dsgn_model_routes_a_tar_to_the_compat_model(tmp_path, capsys):
    _, sd = _upstream_sd()
    path = str(tmp_path / "finetune_53.tar")
    torch.save({"state_dict": sd}, path)

    class Args:
        ckpt = path
    model = make_dsgn_model(Args, DSGNConfig.tiny(), torch.device("cpu"))
    assert isinstance(model, TC.DSGNCompat)
    assert not any(p.requires_grad for p in model.parameters())
    assert not model.training
    assert "unmapped 0" in capsys.readouterr().out


CALIB = ("P2: 180.0 0.0 160.0 11.2 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n"
         "P3: 180.0 0.0 160.0 -86.0 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n")
LABEL = "Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 18.0 0.4\n"


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("compat_cli")
    data = str(root / "kitti")
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2"):
        os.makedirs(os.path.join(data, sub))
    for fid in ("000001", "000002"):
        left = rng.randint(0, 256, (90, 300, 3)).astype(np.uint8)
        TK.write_png(os.path.join(data, "image_2", fid + ".png"), left)
        TK.write_png(os.path.join(data, "image_3", fid + ".png"),
                     np.roll(left, -5, axis=1))
        for sub, text in (("calib", CALIB), ("label_2", LABEL)):
            with open(os.path.join(data, sub, fid + ".txt"), "w") as f:
                f.write(text)
    model, sd = _upstream_sd(DSGNConfig.tiny())
    with torch.no_grad():                   # boxes at the default threshold
        model.rpn3d.cls_logits.bias.fill_(1.0)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, str(root / "dsgn.tar"))
    return root, data


def test_attack_cli_runs_on_a_published_layout_tar(cli_data, capsys):
    from eval_driving_safety_tpu_torch.cli import pgd_attack
    root, data = cli_data
    pgd_attack.main(["--data_path", data, "--detector", "dsgn", "--scale",
                     "tiny", "--device", "cpu", "--iter", "2", "--ckpt",
                     str(root / "dsgn.tar"), "--out_prefix",
                     str(root / "adv" / "dsgn_pgd"), "--sync_io"])
    assert "upstream-compat model" in capsys.readouterr().out
    for k in range(3):
        for sub in ("image_2", "image_3"):
            for fid in ("000001", "000002"):
                p = root / "adv" / f"dsgn_pgd_iters_{k}" / sub / (fid + ".png")
                assert TK.load_image_u8(str(p)).shape == (90, 300, 3)


def test_predict_cli_runs_on_a_published_layout_tar(cli_data):
    from eval_driving_safety_tpu_torch.cli import predict_and_save
    root, data = cli_data
    res = root / "res"
    predict_and_save.main(["--data_path", data, "--detector", "dsgn",
                           "--scale", "tiny", "--device", "cpu", "--ckpt",
                           str(root / "dsgn.tar"), "--result_dir", str(res),
                           "--eval_ap"])
    n_lines = 0
    for fid in ("000001", "000002"):
        lines = (res / "data" / (fid + ".txt")).read_text().splitlines()
        assert all(len(ln.split(" ")) == 16 for ln in lines)
        n_lines += len(lines)
    assert n_lines > 0
    assert (res / "metrics.jsonl").exists()


def test_patch_cli_runs_on_a_published_layout_tar(cli_data):
    from eval_driving_safety_tpu_torch.cli import patch_attack
    root, data = cli_data
    patch_attack.main(["--data_path", data, "--detector", "dsgn", "--scale",
                       "tiny", "--device", "cpu", "--epochs", "1", "--iters",
                       "1", "--ckpt", str(root / "dsgn.tar"), "--save_dir",
                       str(root / "patch")])
    raw = np.load(root / "patch" / "epoch1" / "patch.npy")
    assert raw.shape == (1, 3, 19, 19) and np.isfinite(raw).all()
    assert np.abs(raw).max() > 0
