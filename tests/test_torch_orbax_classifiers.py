"""The JAX classifier trainers' orbax checkpoints in the port, on the
CPU: each JAX trainer writes epoch 1 at 64 px, as
tests/test_torch_classifier_cli.py runs the classifiers; the reader
against orbax's restore, bit for bit; validate_classifier's accuracy
and classify_split's folders on the JAX `epochN/` against the same
weights bridged into the port's checkpoint.pt, equal.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest

from eval_driving_safety_tpu.cli import train_classifier as jax_cls_train
from eval_driving_safety_tpu.config import (
    DynamicVehicleConfig as JaxDynCfg, RoadTypeConfig as JaxRoadCfg)
from eval_driving_safety_tpu.utils.checkpoint import restore_checkpoint
from eval_driving_safety_tpu_torch.cli import (classify_split,
                                               train_classifier,
                                               validate_classifier)
from eval_driving_safety_tpu_torch.config import (DynamicVehicleConfig,
                                                   RoadTypeConfig)
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.utils import orbax_read as R
from eval_driving_safety_tpu_torch.utils.from_flax import (
    dynamic_vehicle_state_dict_from_flax, road_type_state_dict_from_flax)
from test_torch_cli import _kitti_dir
from test_torch_orbax import (IDS, _assert_same_tree, _bridged, _files,
                              _np, one_torch_thread)  # noqa: F401

SIZE = 64


def _classifier_configs(mp):
    """64-px configs for both packages' classifier CLIs, the JAX trainer
    saving every epoch (its DynamicVehicleConfig has no ckpt_every)."""
    mp.setattr(jax_cls_train, "RoadTypeConfig", lambda: dataclasses.replace(
        JaxRoadCfg(), image_size=SIZE, ckpt_every=1))
    mp.setattr(jax_cls_train, "DynamicVehicleConfig",
               lambda: types.SimpleNamespace(**{
                   **dataclasses.asdict(JaxDynCfg()), "image_size": SIZE,
                   "ckpt_every": 1}))
    mp.setattr(train_classifier, "RoadTypeConfig", lambda: (
        dataclasses.replace(RoadTypeConfig(), image_size=SIZE)))
    mp.setattr(train_classifier, "DynamicVehicleConfig", lambda: (
        dataclasses.replace(DynamicVehicleConfig(), image_size=SIZE)))


@pytest.fixture(scope="module")
def classifiers(tmp_path_factory):
    """Four seeded images, their CSV and each JAX classifier trainer's
    epoch1/ at 64 px."""
    root = tmp_path_factory.mktemp("jax_classifiers")
    rng = np.random.RandomState(0)
    (root / "img").mkdir()
    for i in range(4):
        K.write_png(str(root / "img" / f"{i}.png"),
                    (rng.rand(40, 60, 3) * 64 * (i + 1)).astype(np.uint8))
    (root / "rows.csv").write_text(
        "".join(f"{i}.png,{i % 2}\n" for i in range(4)))
    argv = sys.argv
    with pytest.MonkeyPatch.context() as mp:
        _classifier_configs(mp)
        for task in ("road_type", "dynamic_vehicle"):
            sys.argv = ["train_classifier", "--task", task, "--image_dir",
                        str(root / "img"), "--train_csv",
                        str(root / "rows.csv"), "--epochs", "1", "--batch",
                        "2", "--ckpt_dir", str(root / task)]
            try:
                jax_cls_train.main()
            finally:
                sys.argv = argv
    return root

@pytest.mark.parametrize("task", ["road_type", "dynamic_vehicle"])
def test_read_orbax_equals_restore(classifiers, task):
    path = str(classifiers / task / "epoch1")
    _assert_same_tree(R.read_orbax(path), restore_checkpoint(path), path)


def test_classifier_clis_read_the_jax_checkpoints(classifiers, tmp_path,
                                                  monkeypatch, capsys):
    """validate_classifier's accuracy for each task and classify_split's
    folders on the JAX trainers' epoch1/ equal those on the bridged
    checkpoints."""
    _classifier_configs(monkeypatch)
    ckpts = {}
    for task, bridge in (("road_type", road_type_state_dict_from_flax),
                         ("dynamic_vehicle",
                          dynamic_vehicle_state_dict_from_flax)):
        path = str(classifiers / task / "epoch1")
        tree = restore_checkpoint(path)
        ckpts[task] = {"orbax": path, "bridged": _bridged(
            tmp_path / task, tree, bridge(_np(tree["params"])))}
        printed = {}
        for kind, ckpt in ckpts[task].items():
            capsys.readouterr()
            validate_classifier.main([
                "--task", task, "--image_dir", str(classifiers / "img"),
                "--val_csv", str(classifiers / "rows.csv"), "--ckpt", ckpt,
                "--batch", "3", "--device", "cpu"])
            printed[kind] = capsys.readouterr().out
        assert printed["orbax"].startswith("accuracy: ")
        assert printed["orbax"] == printed["bridged"]
    data = str(tmp_path / "kitti")
    _kitti_dir(data, IDS)
    written = []
    for kind in ("orbax", "bridged"):
        out = str(tmp_path / f"split_{kind}")
        classify_split.main([
            "--data_path", data, "--road_ckpt", ckpts["road_type"][kind],
            "--dyn_ckpt", ckpts["dynamic_vehicle"][kind], "--out_dir", out,
            "--device", "cpu"])
        written.append(_files(out))
    assert written[0] and written[0] == written[1]
