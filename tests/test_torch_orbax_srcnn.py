"""The JAX Stereo R-CNN trainer's orbax checkpoints in the port, on the
CPU: the JAX trainer writes epoch 1 of `--tiny` over two frames (two
steps, the second at lr 1e-3, so that `uncert` moves); the reader
against orbax's restore; the attack (its loss), predict and patch CLIs
on the JAX `epochN/` against the same weights bridged into the port's
checkpoint.pt, bit for bit; the port's trainer resumed from it at
learning rate 0, carrying the network and `uncert` bit for bit.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.cli import train_detector as jax_train
from eval_driving_safety_tpu.utils.checkpoint import restore_checkpoint
from eval_driving_safety_tpu_torch.cli import (patch_attack, pgd_attack,
                                               predict_and_save)
from eval_driving_safety_tpu_torch.cli import train_detector as T
from eval_driving_safety_tpu_torch.cli.common import load_classifier
from eval_driving_safety_tpu_torch.config import (RoadTypeConfig,
                                                   StereoRCNNConfig)
from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
from eval_driving_safety_tpu_torch.utils import checkpoint as C
from eval_driving_safety_tpu_torch.utils import orbax_read as R
from eval_driving_safety_tpu_torch.utils.from_flax import \
    stereo_rcnn_state_dict_from_flax
from test_torch_cli import _kitti_dir
from test_torch_orbax import (IDS, _assert_same_tree, _both, _bridged, _np,
                              one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("orbax_frames") / "kitti")
    _kitti_dir(data, IDS)
    return data


@pytest.fixture(scope="module")
def srcnn(tmp_path_factory, frames):
    """The JAX Stereo R-CNN trainer's epoch1/: two steps, the second at
    lr 1e-3 (warmup of 1 step)."""
    ck = str(tmp_path_factory.mktemp("jax_srcnn") / "ck")
    jax_train.main(["--data_path", frames, "--detector", "srcnn", "--tiny",
                    "--epochs", "1", "--warmup_steps", "1", "--ckpt_dir",
                    ck])
    return ck

def test_read_orbax_equals_restore(srcnn):
    """params, uncert, opt_state and epoch, leaf for leaf, bit for bit."""
    path = os.path.join(srcnn, "epoch1")
    tree = R.read_orbax(path)
    _assert_same_tree(tree, restore_checkpoint(path), path)
    assert tree["uncert"].dtype == np.float32


SRCNN_CLIS = {
    "pgd_attack": lambda data, ckpt, out: pgd_attack.main([
        "--data_path", data, "--detector", "srcnn", "--tiny", "--iter", "1",
        "--device", "cpu", "--ckpt", ckpt,
        "--out_prefix", os.path.join(out, "srcnn_pgd")]),
    "predict_and_save": lambda data, ckpt, out: predict_and_save.main([
        "--data_path", data, "--detector", "srcnn", "--tiny", "--device",
        "cpu", "--ckpt", ckpt, "--result_dir", out]),
    "patch_attack": lambda data, ckpt, out: patch_attack.main([
        "--data_path", data, "--detector", "srcnn", "--tiny", "--device",
        "cpu", "--epochs", "1", "--ckpt", ckpt, "--save_dir", out]),
}


@pytest.mark.parametrize("cli", SRCNN_CLIS)
def test_srcnn_clis_read_the_jax_checkpoint(srcnn, frames, tmp_path, capsys,
                                            cli):
    """The attack's loss and PNGs, predict's txts and the patch attack's
    patch on the JAX trainer's epoch1/ (its `uncert` included) equal
    those on the bridged checkpoint."""
    path = os.path.join(srcnn, "epoch1")
    tree = restore_checkpoint(path)
    model = StereoRCNN(StereoRCNNConfig.tiny())
    ckpts = {"orbax": path, "bridged": _bridged(
        tmp_path, tree,
        stereo_rcnn_state_dict_from_flax(_np(tree["params"]), model))}

    def run(ckpt, out):
        capsys.readouterr()
        SRCNN_CLIS[cli](frames, ckpt, out)
        return capsys.readouterr().out
    (got, got_out), (want, want_out) = _both(tmp_path, ckpts, run)
    assert got and got == want and got_out == want_out
    if cli == "pgd_attack":
        assert "losses [" in got_out[-1]
    uncert = np.asarray(tree["uncert"])
    assert np.abs(uncert).max() > 0
    printed = run(path, str(tmp_path / "again"))
    assert f"uncert {uncert.tolist()}" in printed

def test_a_stereo_rcnn_tree_is_refused_by_dsgn_and_a_classifier(
        srcnn, tmp_path):
    path = os.path.join(srcnn, "epoch1")
    with pytest.raises(SystemExit, match="holds no DSGN weights at this "
                       "scale; --ckpt takes .*JAX package's trainer"):
        pgd_attack.main(["--data_path", str(tmp_path), "--scale", "tiny",
                         "--device", "cpu", "--ckpt", path])
    with pytest.raises(SystemExit, match="holds no road_type classifier"):
        load_classifier("road_type", RoadTypeConfig(), path, "cpu")


def test_srcnn_resume_carries_uncert(srcnn, frames, tmp_path, capsys):
    """The port's trainer resumed from the JAX Stereo R-CNN trainer's
    epoch1/ at learning rate 0: the network and `uncert` come through bit
    for bit, the step count goes on from the optax state's."""
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(srcnn, "epoch1"),
                    os.path.join(ck, "epoch1"))
    T.main(["--data_path", frames, "--detector", "srcnn", "--tiny",
            "--epochs", "1", "--lr", "0", "--ckpt_dir", ck, "--resume",
            "--device", "cpu"])
    assert f"resumed from {os.path.join(ck, 'epoch1')} (epoch 1)" in \
        capsys.readouterr().out
    got = C.restore_checkpoint(os.path.join(ck, "epoch2"))
    jax1 = _np(restore_checkpoint(os.path.join(srcnn, "epoch1")))
    want = stereo_rcnn_state_dict_from_flax(
        jax1["params"], StereoRCNN(StereoRCNNConfig.tiny()))
    for name, v in want.items():
        assert torch.equal(got["params"][name], v), name
    assert np.abs(jax1["uncert"]).max() > 0
    assert np.array_equal(got["uncert"].numpy(), jax1["uncert"])
    assert got["opt_state"]["count"] == 2 + len(IDS)
