"""The JAX DSGN trainer's orbax checkpoints in the port, on the CPU: the
JAX trainer writes epoch 1 and epoch 2 of `--tiny` over two frames (fp32
on both sides, so that the resume is compared to the arithmetic's
rounding and not to bf16's); the reader against orbax's restore; the
attack, predict and patch CLIs on the JAX `epochN/` against the same
weights bridged into the port's checkpoint.pt; the port's trainer resumed
from JAX's epoch 1 against JAX's epoch 2.

Tolerances: the reader and the CLIs bit for bit (the same weights, the
same arithmetic); the resume's parameters within 1e-5 of each tensor's
largest magnitude, the relative tolerance of tests/test_torch_train.py's
`test_training_loss_matches_jax`, plus 1e-4 of its largest change in
epoch 2, and its Adam moments within 1e-4 of their largest magnitude,
the tolerance of `test_every_parameter_gradient_matches_jax` (the same
fp32 steps summed in other orders).
"""
import dataclasses
import os
import shutil

import pytest

from eval_driving_safety_tpu.cli import train_detector as jax_train
from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.utils.checkpoint import restore_checkpoint
from eval_driving_safety_tpu_torch.cli import (patch_attack, pgd_attack,
                                               predict_and_save)
from eval_driving_safety_tpu_torch.cli import train_detector as T
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.utils import checkpoint as C
from eval_driving_safety_tpu_torch.utils import orbax_read as R
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax
from test_torch_cli import _kitti_dir
from test_torch_orbax import (IDS, _assert_same_tree, _both, _bridged, _np,
                              one_torch_thread)  # noqa: F401


def _fp32_tiny(mp):
    """DSGN's tiny config in fp32 on both sides."""
    for cls in (JaxDSGNConfig, DSGNConfig):
        tiny = cls.tiny
        mp.setattr(cls, "tiny", staticmethod(
            lambda tiny=tiny: dataclasses.replace(tiny(), dtype="float32")))

@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("orbax_frames") / "kitti")
    _kitti_dir(data, IDS)
    return data


@pytest.fixture(scope="module")
def dsgn(tmp_path_factory, frames):
    """The JAX DSGN trainer's epoch1/ and epoch2/ in fp32 (one run of 2
    epochs: its schedule is the resumed run's, warmup-bound either
    way)."""
    ck = str(tmp_path_factory.mktemp("jax_dsgn") / "ck")
    with pytest.MonkeyPatch.context() as mp:
        _fp32_tiny(mp)
        jax_train.main(["--data_path", frames, "--detector", "dsgn",
                        "--tiny", "--epochs", "2", "--ckpt_every", "1",
                        "--ckpt_dir", ck])
    return ck


def test_read_orbax_equals_restore(dsgn):
    """Both epochs: params, opt_state (None where optax stored an empty
    or masked state) and epoch, leaf for leaf, bit for bit."""
    for e in (1, 2):
        path = os.path.join(dsgn, f"epoch{e}")
        tree = R.read_orbax(path)
        _assert_same_tree(tree, restore_checkpoint(path), path)
        assert tree["epoch"] == e


DSGN_CLIS = {
    "pgd_attack": lambda data, ckpt, out: pgd_attack.main([
        "--data_path", data, "--detector", "dsgn", "--scale", "tiny",
        "--iter", "1", "--batch", "1", "--device", "cpu", "--ckpt", ckpt,
        "--out_prefix", os.path.join(out, "dsgn_pgd")]),
    "predict_and_save": lambda data, ckpt, out: predict_and_save.main([
        "--data_path", data, "--detector", "dsgn", "--scale", "tiny",
        "--device", "cpu", "--ckpt", ckpt, "--result_dir", out,
        "--save_depth_dir", os.path.join(out, "depth")]),
    "patch_attack": lambda data, ckpt, out: patch_attack.main([
        "--data_path", data, "--detector", "dsgn", "--scale", "tiny",
        "--device", "cpu", "--epochs", "1", "--ckpt", ckpt,
        "--save_dir", out]),
}


@pytest.mark.parametrize("cli", DSGN_CLIS)
def test_dsgn_clis_read_the_jax_checkpoint(dsgn, frames, tmp_path, capsys,
                                           cli):
    """The attack's first iteration (its PNGs and loss), predict (its
    txts and depth maps) and the patch attack (its patch) on the JAX
    trainer's epoch1/ equal those on the bridged checkpoint."""
    path = os.path.join(dsgn, "epoch1")
    tree = restore_checkpoint(path)
    ckpts = {"orbax": path, "bridged": _bridged(
        tmp_path, tree, dsgn_state_dict_from_flax(_np(tree["params"])))}

    def run(ckpt, out):
        capsys.readouterr()
        DSGN_CLIS[cli](frames, ckpt, out)
        return capsys.readouterr().out
    (got, got_out), (want, want_out) = _both(tmp_path, ckpts, run)
    assert got and got == want and got_out == want_out
    assert got_out or cli == "predict_and_save"
    assert f"loaded DSGN weights from {path} (the JAX trainer's orbax " \
        "checkpoint)" in run(path, str(tmp_path / "again"))

def test_a_dsgn_tree_is_refused_by_stereo_rcnn(dsgn, tmp_path):
    with pytest.raises(SystemExit, match="holds no Stereo R-CNN weights at "
                       "this config; --ckpt takes .*JAX package's trainer"):
        pgd_attack.main(["--data_path", str(tmp_path), "--detector",
                         "srcnn", "--tiny", "--device", "cpu", "--ckpt",
                         os.path.join(dsgn, "epoch1")])


def test_dsgn_resume_continues_the_jax_run(dsgn, frames, tmp_path, capsys,
                                           monkeypatch):
    """The port's trainer resumed from the JAX trainer's epoch1/ over the
    same frames writes the JAX trainer's own epoch 2, each tensor within
    the tolerances of test_torch_train.py: its parameters within 1e-5 of
    the tensor's largest magnitude (the loss's) plus 1e-4 of its largest
    change in epoch 2 (the gradients', of which the change is a
    function), its Adam moments, sums of the gradients, within 1e-4 of
    their largest magnitude; the same step count."""
    _fp32_tiny(monkeypatch)
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(dsgn, "epoch1"),
                    os.path.join(ck, "epoch1"))
    T.main(["--data_path", frames, "--detector", "dsgn", "--tiny",
            "--epochs", "1", "--ckpt_every", "1", "--ckpt_dir", ck,
            "--resume", "--device", "cpu"])
    assert f"resumed from {os.path.join(ck, 'epoch1')} (epoch 1)" in \
        capsys.readouterr().out
    got = C.restore_checkpoint(os.path.join(ck, "epoch2"))
    jax2 = _np(restore_checkpoint(os.path.join(dsgn, "epoch2")))
    jax1 = _np(restore_checkpoint(os.path.join(dsgn, "epoch1")))
    adam = jax2["opt_state"][1]["inner_state"][0]
    assert got["epoch"] == 2 and got["opt_state"]["count"] == int(
        adam["count"]) == 4
    mu = dsgn_state_dict_from_flax(T._pruned(adam["mu"]))
    nu = dsgn_state_dict_from_flax(T._pruned(adam["nu"]))
    want = dsgn_state_dict_from_flax(jax2["params"])
    before = dsgn_state_dict_from_flax(jax1["params"])
    state = got["opt_state"]["adamw"]["state"]
    net = [n for n, _ in DSGN(DSGNConfig.tiny()).named_parameters()
           if n.rsplit(".", 1)[-1] not in ("mean", "var")]
    assert len(state) == len(net) == len(mu)
    for i, name in enumerate(net):
        assert int(state[i]["step"]) == 4
        for got_t, want_t in ((state[i]["exp_avg"], mu[name]),
                              (state[i]["exp_avg_sq"], nu[name])):
            tol = 1e-4 * float(want_t.abs().max())
            assert float((got_t - want_t).abs().max()) <= tol, name
    moved = []
    for name in want:
        change = float((want[name] - before[name]).abs().max())
        tol = 1e-5 * float(want[name].abs().max()) + 1e-4 * change
        assert float((got["params"][name] - want[name]).abs().max()) <= \
            tol, name
        if tol:
            moved.append(change / tol)
    assert max(moved) > 10
