"""The classifier CLIs of the port on the CPU (`--device cpu`) on seeded
KITTI-layout frames in tmp_path: crop_images against JAX's (decoded
pixels within 1 level: the same crop rounded to u8 after f32 sums in
other orders), then train_classifier -> validate_classifier ->
classify_split, and classify_split against JAX's on bridged weights whose
head biases put every score far from the threshold (the same folders,
byte for byte).

The classifiers run at 64 px here (the CLIs' configs are swapped for
64-px ones on both sides); the published 224 px runs in chip_smoke.py.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eval_driving_safety_tpu.cli import classify_split as jax_classify
from eval_driving_safety_tpu.cli import crop_images as jax_crop
from eval_driving_safety_tpu.config import (
    DynamicVehicleConfig as JaxDynCfg, RoadTypeConfig as JaxRoadCfg)
from eval_driving_safety_tpu.models import classifiers as JC
from eval_driving_safety_tpu.utils.checkpoint import \
    save_checkpoint as jax_save
from eval_driving_safety_tpu_torch.cli import (classify_split, crop_images,
                                               train_classifier,
                                               validate_classifier)
from eval_driving_safety_tpu_torch.config import (DynamicVehicleConfig,
                                                   RoadTypeConfig)
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.models import classifiers as C
from eval_driving_safety_tpu_torch.utils import checkpoint as CK
from eval_driving_safety_tpu_torch.utils.from_flax import (
    dynamic_vehicle_state_dict_from_flax, road_type_state_dict_from_flax)

SIZE = 64
IDS = ["000001", "000002", "000003", "000004"]


def _line(cls, x1, y1, x2, y2):
    return (f"{cls} 0.00 0 -1.58 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} 1.50 "
            "1.70 4.00 2.00 1.60 18.00 0.40")


def _labels(rng):
    """Vehicles of every kind and size, a pedestrian, a DontCare and a box
    past the image's edge."""
    def box(lo, hi):
        x1, y1 = rng.uniform(0, 300), rng.uniform(0, 90)
        s = rng.uniform(lo, hi)
        return x1, y1, x1 + s * rng.uniform(0.8, 1.6), y1 + s
    return [_line("Car", *box(8, 40)), _line("Pedestrian", *box(10, 30)),
            _line("Van", *box(20, 60)), _line("Truck", *box(30, 90)),
            _line("Misc", *box(10, 20)), _line("DontCare", *box(5, 10)),
            _line("Car", 330.0, 60.0, 420.0, 130.0)]


def _kitti(root):
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "label_2", "annotation"):
        os.makedirs(os.path.join(root, sub))
    for n, fid in enumerate(IDS):
        # frames of different brightness, so that their scores differ
        img = (rng.rand(120, 360, 3) * 64 * (n + 1)).astype(np.uint8)
        K.write_png(os.path.join(root, "image_2", fid + ".png"), img)
        K.write_png(os.path.join(root, "image_3", fid + ".png"), img)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write("\n".join(_labels(rng)) + "\n")
        # codes for the first lines only (the rest count as 0); frame 4
        # has no annotation file
        if n < 3:
            with open(os.path.join(root, "annotation", fid + ".txt"),
                      "w") as f:
                f.write(["1\nn\n0\n-1\n", "0\nn\nn\n", "-1\n0\n0\nn\n"][n])


def _small_configs(monkeypatch):
    """64-px configs for the port's CLIs and JAX's classify_split; the
    road-type config saves every 2 epochs."""
    monkeypatch.setattr(train_classifier, "RoadTypeConfig", lambda: (
        dataclasses.replace(RoadTypeConfig(), image_size=SIZE,
                            ckpt_every=2)))
    monkeypatch.setattr(train_classifier, "DynamicVehicleConfig", lambda: (
        dataclasses.replace(DynamicVehicleConfig(), image_size=SIZE)))
    monkeypatch.setattr(jax_classify, "RoadTypeConfig", lambda: (
        dataclasses.replace(JaxRoadCfg(), image_size=SIZE)))
    monkeypatch.setattr(jax_classify, "DynamicVehicleConfig", lambda: (
        dataclasses.replace(JaxDynCfg(), image_size=SIZE)))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_crop_images_matches_jax(tmp_path, monkeypatch, capsys):
    data = str(tmp_path / "kitti")
    _kitti(data)
    common = ["--image_dir", os.path.join(data, "image_2"), "--label_dir",
              os.path.join(data, "label_2"), "--annotation_dir",
              os.path.join(data, "annotation")]
    crop_images.main(common + ["--out_dir", str(tmp_path / "p"), "--csv",
                               str(tmp_path / "p.csv"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["crop_images"] + common + [
        "--out_dir", str(tmp_path / "j"), "--csv", str(tmp_path / "j.csv")])
    jax_crop.main()
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    # 4 frames x 4 vehicles (Car, Van, Truck, the clipped Car; Misc is not
    # cropped), less the lines coded n
    assert len(names) == 4 * 4 - 2
    assert {n[-5] for n in names} == {"d", "s"}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    for name in names:
        got = K.load_image_u8(str(tmp_path / "p" / name)).astype(int)
        want = K.load_image_u8(str(tmp_path / "j" / name)).astype(int)
        assert got.shape == want.shape == (224, 224, 3)
        assert np.abs(got - want).max() <= 1, name
    assert f"wrote {len(names)} crops" in capsys.readouterr().out


def test_train_validate_classify_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Both tasks through train_classifier (batch order from
    RandomState(seed + epoch), validation every 2 epochs, checkpoints with
    the backbone at its init bit for bit), validate_classifier and
    classify_split on the checkpoints."""
    _small_configs(monkeypatch)
    data = str(tmp_path / "kitti")
    _kitti(data)
    crop_images.main([
        "--image_dir", os.path.join(data, "image_2"), "--label_dir",
        os.path.join(data, "label_2"), "--annotation_dir",
        os.path.join(data, "annotation"), "--out_dir",
        str(tmp_path / "crops"), "--csv", str(tmp_path / "crops.csv"),
        "--device", "cpu"])
    rows = C.read_csv_dataset(str(tmp_path / "crops.csv"))
    (tmp_path / "frames.csv").write_text(
        "".join(f"{fid}.png,{i % 2}\n" for i, fid in enumerate(IDS)))
    seen = []
    load = train_classifier.load_batch

    def recording_load(image_dir, chunk, cfg, device):
        seen.append([name for name, _ in chunk])
        return load(image_dir, chunk, cfg, device)
    monkeypatch.setattr(train_classifier, "load_batch", recording_load)

    runs = {"dynamic_vehicle": (str(tmp_path / "crops"), "crops.csv", 5, 4),
            "road_type": (os.path.join(data, "image_2"), "frames.csv", 2, 2)}
    for task, (image_dir, csv, epochs, batch) in runs.items():
        seen.clear()
        ck = str(tmp_path / task)
        capsys.readouterr()
        train_classifier.main([
            "--task", task, "--image_dir", image_dir, "--train_csv",
            str(tmp_path / csv), "--val_csv", str(tmp_path / csv),
            "--epochs", str(epochs), "--batch", str(batch), "--ckpt_dir", ck,
            "--seed", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        task_rows = C.read_csv_dataset(str(tmp_path / csv))
        n = len(task_rows)
        # each epoch's training batches, and every 2 epochs the
        # validation batches in file order
        want = []
        for e in range(epochs):
            perm = np.random.RandomState(3 + e).permutation(n)
            want += [[task_rows[i][0] for i in perm[s: s + batch]]
                     for s in range(0, n - batch + 1, batch)]
            if (e + 1) % 2 == 0:
                want += [[r[0] for r in task_rows[s: s + batch]]
                         for s in range(0, n, batch)]
        assert seen == want
        for e in range(1, epochs + 1):
            assert f"epoch {e}/{epochs}: loss" in out
        assert out.count("  val accuracy: ") == epochs // 2
        path = os.path.join(ck, f"epoch{epochs}")
        assert f"  checkpoint -> {path}" in out
        assert sorted(os.listdir(ck)) == [f"epoch{epochs}"]
        saved = CK.restore_checkpoint(path)
        assert saved["epoch"] == epochs
        cfg = train_classifier.task_config(task)
        init = C.make_classifier(task, cfg).init_weights(3).state_dict()
        head = C.make_classifier(task, cfg).head_names
        for k, v in init.items():
            if k.split(".")[0] in head:
                if task == "road_type":          # lr 1e-3 moves it
                    assert not torch.equal(saved["params"][k], v), k
            else:
                assert torch.equal(saved["params"][k], v), k

        validate_classifier.main([
            "--task", task, "--image_dir", image_dir, "--val_csv",
            str(tmp_path / csv), "--ckpt", path, "--batch", "3",
            "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("accuracy: ") and out[0].endswith(
            f"/{n})")
        n0 = sum(1 for _, label in task_rows if label == 0)
        assert any(ln.startswith("  class 0: ") and ln.endswith(f"/{n0})")
                   for ln in out)
    assert len(rows) == 14

    classify_split.main([
        "--data_path", data, "--road_ckpt", str(tmp_path / "road_type" /
                                                "epoch2"),
        "--dyn_ckpt", str(tmp_path / "dynamic_vehicle" / "epoch5"),
        "--out_dir", str(tmp_path / "split"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "classified 4 frames: " in out
    files = _tree(str(tmp_path / "split"))
    assert sum(k.endswith("_label/" + f"{fid}.txt") for k in files
               for fid in IDS) == 4
    for k, v in files.items():
        if "annotation" in k:
            codes = v.decode().split()
            assert len(codes) == 7 and set(codes) <= {"n", "0", "1"}
            assert [c == "n" for c in codes] == [
                False, True, False, False, False, True, False]


def _planted(task, scores_of, seed):
    """JAX variables of `task` at 64 px and the port's state dict, with
    the last layer planted: its kernel scaled so that the logits
    `scores_of(state_dict)` gives span 8, and its bias put in the middle
    of the widest gap between them, so every score lies half that gap
    from the threshold 0.5."""
    jm = (JC.RoadTypeClassifier if task == "road_type"
          else JC.DynamicVehicleClassifier)()
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    bridge = (road_type_state_dict_from_flax if task == "road_type"
              else dynamic_vehicle_state_dict_from_flax)
    probs = np.asarray(scores_of(bridge(v)), np.float64)
    logits = np.log(probs / (1 - probs))            # the bias is 0 at init
    scale = 8.0 / (logits.max() - logits.min())
    logits = np.sort(logits * scale)
    i = int(np.argmax(np.diff(logits)))
    assert logits[i + 1] - logits[i] > 0.5
    head = v["params"]["head" if task == "road_type" else "fc2"]
    head["kernel"] = head["kernel"] * np.float32(scale)
    head["bias"] = head["bias"] - np.float32((logits[i] + logits[i + 1]) / 2)
    return v, bridge(v)


def test_classify_split_matches_jax(tmp_path, monkeypatch, capsys):
    """JAX's classify_split and the port's write the same folders: without
    checkpoints (every frame street, every vehicle 0), and with planted
    checkpoints of both classifiers (both buckets and both codes)."""
    _small_configs(monkeypatch)
    data = str(tmp_path / "kitti")
    _kitti(data)
    frames = [torch.from_numpy(K.load_image_u8(os.path.join(
        data, "image_2", fid + ".png"))).float() / 255 for fid in IDS]
    objs = [K.read_label(os.path.join(data, "label_2", fid + ".txt"))
            for fid in IDS]

    def scores(task):
        cfg = train_classifier.task_config(task)

        def of(sd):
            model = C.make_classifier(task, cfg)
            model.load_state_dict(sd)
            step = (C.make_eval_step(model.eval()), cfg)
            out = []
            for img, o in zip(frames, objs):
                road, dyn = classify_split.frame_scores(
                    img, o, step if task == "road_type" else None,
                    step if task == "dynamic_vehicle" else None)
                out += [road] if task == "road_type" else \
                    [s for s in dyn if s is not None]
            return out
        return of

    for task, seed in (("road_type", 1), ("dynamic_vehicle", 2)):
        v, sd = _planted(task, scores(task), seed)
        CK.save_checkpoint(str(tmp_path / "port" / task), {"params": sd})
        jax_save(str(tmp_path / "jax" / task), v)

    for run, with_ckpts in (("none", False), ("planted", True)):
        outs = {}
        for side in ("port", "jax"):
            argv = ["--data_path", data, "--out_dir",
                    str(tmp_path / f"{run}_{side}")]
            if with_ckpts:
                argv += ["--road_ckpt", str(tmp_path / side / "road_type"),
                         "--dyn_ckpt",
                         str(tmp_path / side / "dynamic_vehicle")]
            if side == "port":
                classify_split.main(argv + ["--device", "cpu"])
            else:
                jax_classify.main(argv)
            outs[side] = _tree(str(tmp_path / f"{run}_{side}"))
        assert outs["port"] == outs["jax"], run
        codes = "".join(v.decode() for k, v in outs["port"].items()
                        if "annotation" in k)
        buckets = {k.split("/")[0] for k in outs["port"]}
        if with_ckpts:
            assert {"0", "1", "n"} <= set(codes)
            assert buckets == {"road_dynamic_label",
                               "road_dynamic_annotation", "dynamic_label",
                               "dynamic_annotation"}
        else:
            assert "1" not in codes and buckets == {"dynamic_label",
                                                    "dynamic_annotation"}
