"""The port's DSGN predict path against the JAX package on CPU, and its
CLI end to end.

The slice test bridges the tiny fp32 JAX model's weights (utils.from_flax)
with the BEV head's class bias raised to +1.0 and its w/l biases to +1.5
(boxes of e^1.5 = 4.5 m on the 1.6 m cell grid), so the default score
threshold keeps boxes and NMS suppresses some. Model outputs and the
decoded KITTI fields must agree within rtol 1e-4 (with an absolute floor
of 1e-4 x the largest magnitude), the tolerance of the outputs
themselves (tests/test_torch_dsgn.py): both frameworks compute in fp32
and sum in different orders. Detection counts must be equal; detections
are matched by location, since two kept boxes whose scores agree to 1e-5
may trade places in the score order.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.data import kitti as JK
from eval_driving_safety_tpu.inference import fcos3d_post as JF
from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
from eval_driving_safety_tpu_torch.cli.predict_and_save import (
    FeatureRecorder, main)
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.inference import fcos3d_post as TF
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax

MEAN255 = np.asarray((0.485, 0.456, 0.406), np.float32) * 255.0
STD255 = np.asarray((0.229, 0.224, 0.225), np.float32) * 255.0
F_U, BASELINE, C_U, C_V = 180.0, 0.54, 160.0, 48.0
TOP_LEVEL = ("StereoFeatureNet_0", "Hourglass3D_0", "depth_score0",
             "depth_score1", "depth_score2", "ConvBnRelu2p1D_0",
             "ConvBnRelu2p1D_1", "ConvBnRelu2p1D_2", "BEVHead_0")


def _calib(mod):
    p2 = np.array([[F_U, 0, C_U, 0], [0, F_U, C_V, 0], [0, 0, 1, 0]])
    p3 = p2.copy()
    p3[0, 3] = -BASELINE * F_U
    return mod.Calibration(P2=p2, P3=p3)


def _frames():
    rng = np.random.RandomState(4)
    il = rng.randint(0, 256, (2, 96, 320, 3)).astype(np.float32)
    ir = np.clip(np.roll(il, -6, axis=2) + rng.randint(-8, 9, il.shape),
                 0, 255).astype(np.float32)
    calib = [np.full((2,), v, np.float32) for v in (F_U, BASELINE, C_U, C_V)]
    return (il - MEAN255) / STD255, (ir - MEAN255) / STD255, calib


def _jax_dump_names(tree):
    """The JAX CLI's --save_feat_dir names of a captured tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("_".join(getattr(p, "key", str(p)) for p in path)[:120],
             np.asarray(v)) for path, v in flat]


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    il, ir, calib = _frames()
    jm = JaxDSGN(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), il[:1], ir[:1],
                              *(c[:1] for c in calib))
    params = jax.tree_util.tree_map(np.array, params)
    head = params["params"]["BEVHead_0"]
    head["cls"]["bias"][:] = 1.0
    head["reg"]["bias"][4:6] = 1.5
    jout, state = jm.apply(params, il, ir, *calib, capture_intermediates=True,
                           mutable=["intermediates"])
    jdets = JF.decode_bev_outputs(jout, jcfg)
    model = DSGN(tcfg)
    model.load_state_dict(dsgn_state_dict_from_flax(params))
    with torch.inference_mode(), FeatureRecorder(model) as rec:
        tout = model(*(torch.from_numpy(a) for a in (il, ir)),
                     *(torch.from_numpy(c) for c in calib))
        tdets = TF.fetch_detections(TF.decode_bev_outputs(tout, tcfg))
    return dict(jout=jax.tree_util.tree_map(np.asarray, jout), jdets=jdets,
                jfeats=_jax_dump_names(state["intermediates"]), tout=tout,
                tdets=tdets, tfeats=rec.flat())


def _close(got, want, rtol=1e-4, floor=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-12))


def test_slice_outputs_match_jax(slice_pair):
    jout, tout = slice_pair["jout"], slice_pair["tout"]
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        _close(tout[k].numpy(), jout[k])
    for got, want in zip(tout["depth_preds"], jout["depth_preds"]):
        _close(got.numpy(), want)


def test_slice_detections_and_kitti_lines_match_jax(slice_pair):
    jd, td = slice_pair["jdets"], slice_pair["tdets"]
    jvalid = np.asarray(jd.valid)
    assert np.array_equal(td.valid.sum(1), jvalid.sum(1))
    assert jvalid.sum() > 0                  # the threshold keeps boxes
    # ... and NMS suppressed some of the 50 best-scored candidates
    smap = (torch.sigmoid(slice_pair["tout"]["bbox_cls"])
            * torch.sigmoid(slice_pair["tout"]["bbox_centerness"])[..., None])
    top50 = torch.sort(smap.reshape(2, -1), dim=-1, descending=True,
                       stable=True).indices[:, :50].numpy()
    for i in range(2):
        assert set(td.index[i][td.valid[i]]) != set(top50[i])
    for i in range(2):
        want = JF.detections_to_kitti(
            jax.tree_util.tree_map(lambda x: np.asarray(x)[i], jd),
            _calib(JK), (96, 320))
        got = TF.detections_to_kitti(
            TF.Detections3D(*(f[i] for f in td)), _calib(TK), (96, 320))
        assert len(got) == len(want) > 0
        loc = lambda ds: np.array([d["location"] for d in ds])
        order = [int(np.argmin(np.abs(loc(got) - w).sum(1)))
                 for w in loc(want)]
        assert sorted(order) == list(range(len(got)))
        got = [got[j] for j in order]
        for key in ("bbox", "dimensions", "location", "rotation_y", "score"):
            _close([np.asarray(d[key], np.float64) for d in got],
                   [np.asarray(d[key], np.float64) for d in want])
        assert [d["type"] for d in got] == [d["type"] for d in want]


def test_slice_feature_dumps_of_top_level_modules_match_jax(slice_pair):
    """The top-level modules' dumps carry the JAX CLI's names; their
    values agree within the outputs' tolerance. (Nested modules differ
    between the two packages, so the dumps' running numbers may too.)"""
    def tops(feats):
        return {n: v for n, v in feats
                if n.split("___call___")[0] in TOP_LEVEL
                or n.startswith("__call___")}          # the model's outputs
    want, got = tops(slice_pair["jfeats"]), tops(slice_pair["tfeats"])
    assert set(got) == set(want) and len(got) == 20
    for name, w in want.items():
        _close(got[name].numpy(), w)


CALIB = ("P2: 180.0 0.0 160.0 11.2 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n"
         "P3: 180.0 0.0 160.0 -86.0 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n")
LABEL = ("Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 18.0 "
         "0.4\nCar 0.00 0 1.2 10.0 45.0 60.0 90.0 1.5 1.7 4.0 -9.0 1.6 30.0 "
         "1.1\n")


def _kitti_dir(root, ids, hw=(90, 300)):
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2", "depth"):
        os.makedirs(os.path.join(root, sub))
    for fid in ids:
        left = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        TK.write_png(os.path.join(root, "image_2", fid + ".png"), left)
        TK.write_png(os.path.join(root, "image_3", fid + ".png"),
                     np.roll(left, -5, axis=1))
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write(LABEL)
        depth = np.where(rng.rand(*hw) < 0.3, rng.uniform(1, 70, hw), 0.0)
        np.save(os.path.join(root, "depth", fid + ".npy"),
                depth.astype(np.float32))


@pytest.fixture(scope="module")
def predict_data(tmp_path_factory):
    """Tiny frames, and the weights of a seeded init with the class bias
    raised to +1.0: random weights export no box at the default score
    threshold."""
    root = tmp_path_factory.mktemp("predict")
    data = str(root / "kitti")
    _kitti_dir(data, ["000001", "000002"])
    model = DSGN(DSGNConfig.tiny()).init_weights(0)
    with torch.no_grad():
        model.BEVHead_0.cls.bias.fill_(1.0)
    torch.save(model.state_dict(), root / "w.pt")
    return root, data


def _run(root, data, out, *extra):
    main(["--data_path", data, "--detector", "dsgn", "--scale", "tiny",
          "--device", "cpu", "--ckpt", str(root / "w.pt"), "--result_dir",
          str(out), *extra])


def test_cli_writes_the_reference_layout(predict_data, capsys):
    root, data = predict_data
    out = root / "res"
    _run(root, data, out, "--eval_ap", "--depth_dir",
         os.path.join(data, "depth"), "--save_depth_dir", str(root / "sd"),
         "--save_lidar_dir", str(root / "sl"), "--plot", "--save_input_dir",
         str(root / "si"))
    stdout = capsys.readouterr().out
    assert "AP (Car, moderate, IoU 0.70)" in stdout
    assert "depth error: mean" in stdout
    for fid in ("000001", "000002"):
        lines = (out / "data" / f"{fid}.txt").read_text().splitlines()
        assert lines and all(len(ln.split(" ")) == 16 for ln in lines)
        assert (out / "refer" / f"{fid}.png").stat().st_size > 0
        depth = np.load(root / "sd" / f"{fid}.npy")
        assert depth.shape == (96, 320) and depth.dtype == np.float32
        cloud = np.fromfile(root / "sl" / f"{fid}.bin", np.float32)
        assert cloud.size > 0 and cloud.size % 4 == 0
        assert np.all(cloud.reshape(-1, 4)[:, 3] == 1.0)
        for sub in ("image_2", "image_3"):
            img = TK.load_image_u8(str(root / "si" / sub / f"{fid}.png"))
            assert img.shape == (96, 320, 3)
    recs = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert set(recs[0]) == {"depth_mean_err", "depth_median_err"}
    assert set(recs[1]["ap_table"]["Car"]) == {"easy", "moderate", "hard"}
    assert np.isfinite(recs[0]["depth_mean_err"])


def test_cli_rerun_writes_identical_txts_and_feature_dumps(predict_data):
    root, data = predict_data
    for run in ("a", "b"):
        _run(root, data, root / f"rerun_{run}", "--save_feat_dir",
             str(root / f"feat_{run}"), "--debug", "--debugnum", "1")
    a = (root / "rerun_a" / "data" / "000001.txt").read_bytes()
    assert a and a == (root / "rerun_b" / "data" / "000001.txt").read_bytes()
    names = sorted(os.listdir(root / "feat_a" / "000001"))
    assert any(n.endswith("_BEVHead_0___call___[0]_[0].npy") for n in names)
    cls = [n for n in names if n.endswith("__call___[0]_bbox_cls.npy")]
    assert len(cls) == 1
    assert np.load(root / "feat_a" / "000001" / cls[0]).shape == (36, 40, 1)


@pytest.mark.parametrize("mode", ["random", "sp_left", "sp_straight",
                                  "sp_right"])
def test_cli_patch_modes_composite_the_patch(predict_data, mode):
    from eval_driving_safety_tpu_torch.attack import patch as TP
    from eval_driving_safety_tpu_torch.config import PLACEMENT_BANDS
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01
    root, data = predict_data
    rng = np.random.RandomState(5)
    TP.save_patch(str(root / "patch.npy"),
                  torch.from_numpy(rng.rand(21, 21, 3).astype(np.float32)))
    _run(root, data, root / f"patch_{mode}", "--patch_npy",
         str(root / "patch.npy"), "--patch_mode", mode, "--save_input_dir",
         str(root / f"in_{mode}"), "--debug", "--debugnum", "1", "--seed",
         "3")
    clean = TK.pad_to(TK.load_image_u8(os.path.join(
        data, "image_2", "000001.png")), 96, 320)
    saved = TK.load_image_u8(str(root / f"in_{mode}" / "image_2" /
                                 "000001.png"))
    cl, _ = TP.sample_patch_centers(torch.Generator().manual_seed(3), 1, 96,
                                    320, 10,
                                    col_band=PLACEMENT_BANDS[mode])
    want = TP.composite_patch_batch(
        u8_to_01(torch.from_numpy(clean[None])), TP.load_patch(
            str(root / "patch.npy")), cl)[0].numpy()
    np.testing.assert_array_equal(
        saved, np.clip(want * 255.0, 0, 255).astype(np.uint8))
    cols = np.nonzero((saved != clean).any(-1).any(0))[0]
    lo, hi = PLACEMENT_BANDS[mode]
    assert int(320 * lo) - 10 <= cols.min() and cols.max() <= \
        int(320 * hi) + 10


def test_cli_refuses_srcnn(tmp_path):
    with pytest.raises(SystemExit, match="items 9-10"):
        main(["--data_path", str(tmp_path), "--detector", "srcnn"])


def test_cli_takes_every_flag_of_the_jax_cli():
    """Every option string of the JAX CLI's parser parses here."""
    import sys
    from eval_driving_safety_tpu.cli import predict_and_save as J
    argv = sys.argv
    sys.argv = ["predict_and_save", "--data_path", "d"]
    try:
        jax_args = vars(J.parse_args())
    finally:
        sys.argv = argv
    from eval_driving_safety_tpu_torch.cli.predict_and_save import parse_args
    port_args = vars(parse_args(["--data_path", "d"]))
    assert set(jax_args) <= set(port_args)
    assert {k: port_args[k] for k in jax_args} == jax_args
