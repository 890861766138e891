"""The port's attack CLI end to end on CPU at the tiny scale, both
detectors, and its PNG IO (exact comparisons: pixels are integers)."""
import argparse
import os

import numpy as np
import pytest

from eval_driving_safety_tpu_torch.cli.pgd_attack import main
from eval_driving_safety_tpu_torch.data import kitti as K

CALIB = ("P2: 180.0 0.0 160.0 11.2 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n"
         "P3: 180.0 0.0 160.0 -86.0 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n")
LABEL = "Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 18.0 0.4\n"


def _kitti_dir(root, ids, hw=(90, 300)):
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2"):
        os.makedirs(os.path.join(root, sub))
    for fid in ids:
        left = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        K.write_png(os.path.join(root, "image_2", fid + ".png"), left)
        K.write_png(os.path.join(root, "image_3", fid + ".png"),
                    np.roll(left, -5, axis=1), compress_level=6)
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write(LABEL)


def test_cli_tiny_writes_reference_layout_and_transfers_agree(tmp_path):
    ids = ["000001", "000002"]
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ids)
    n = 2
    common = ["--data_path", data, "--detector", "dsgn", "--scale", "tiny",
              "--iter", str(n), "--batch", "1", "--device", "cpu"]
    main(common + ["--out_prefix", str(tmp_path / "s" / "dsgn_pgd")])
    main(common + ["--out_prefix", str(tmp_path / "f" / "dsgn_pgd"),
                   "--transfer", "full", "--sync_io"])
    for fid in ids:
        clean = K.load_image_u8(os.path.join(data, "image_2", fid + ".png"))
        for k in range(n + 1):
            for sub in ("image_2", "image_3"):
                rel = os.path.join(f"dsgn_pgd_iters_{k}", sub, fid + ".png")
                s_bytes = open(tmp_path / "s" / rel, "rb").read()
                assert s_bytes == open(tmp_path / "f" / rel, "rb").read(), rel
            adv = K.load_image_u8(str(tmp_path / "s" / f"dsgn_pgd_iters_{k}"
                                      / "image_2" / (fid + ".png")))
            assert adv.shape == clean.shape
            diff = np.abs(adv.astype(int) - clean.astype(int))
            assert diff.max() <= 77                  # eps 76.5, truncated
            assert (k == 0) == (diff.max() == 0)


def _sweep_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_srcnn_tiny_layout_transfers_and_resume(tmp_path, capsys):
    """--detector srcnn at the tiny config on CPU: the JAX CLI's layout
    (frames saved at network scale, cropped to their resized width), the
    clean frames equal to the JAX package's exact resize, signs and full
    transfers byte-identical, every iterate within the ball, and
    --resume skipping done frames."""
    from eval_driving_safety_tpu.data import dataset as jds
    ids = ["000001", "000002"]
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ids)
    n = 2
    common = ["--data_path", data, "--detector", "srcnn", "--tiny",
              "--iter", str(n), "--device", "cpu"]
    main(common + ["--out_prefix", str(tmp_path / "s" / "stereo_rcnn_pgd")])
    assert "host replay path: native/int" in capsys.readouterr().out
    main(common + ["--out_prefix", str(tmp_path / "f" / "stereo_rcnn_pgd"),
                   "--transfer", "full", "--sync_io"])
    files = _sweep_files(tmp_path / "s")
    assert files == _sweep_files(tmp_path / "f")
    for rel in files:
        assert (tmp_path / "s" / rel).read_bytes() == \
            (tmp_path / "f" / rel).read_bytes(), rel

    # the JAX package's sweep layout and clean frames for these frames
    jset = jds.KittiStereoDataset(data)
    jb = jds.prepare_srcnn_batch_u8([jset.get(i) for i in range(2)],
                                    jds.SRCNNInputConfig(96, 320))
    vl, vr = jds.srcnn_cleanv_host(jb)
    q0 = (jds.quantize_v_batch_u8(vl, jb["c255"]),
          jds.quantize_v_batch_u8(vr, jb["c255"]))
    prefix = str(tmp_path / "j" / "stereo_rcnn_pgd")
    jds.save_sweep(jb, q0, [q0] * n, prefix, lambda x: x, None)
    assert _sweep_files(tmp_path / "j") == files
    for i, fid in enumerate(ids):
        for side, sub in enumerate(("image_2", "image_3")):
            rel = os.path.join("stereo_rcnn_pgd_iters_0", sub, fid + ".png")
            clean = K.load_image_u8(str(tmp_path / "s" / rel))
            assert clean.shape == (96, 320, 3)
            assert np.array_equal(clean, q0[side][i])
            for k in range(1, n + 1):
                adv = K.load_image_u8(str(
                    tmp_path / "s" / rel.replace("iters_0", f"iters_{k}")))
                diff = np.abs(adv.astype(int) - clean.astype(int)).max()
                assert 0 < diff <= 77, (rel, k, diff)    # eps 76.5 px

    last = tmp_path / "s" / files[-1]
    stamp = last.stat().st_mtime_ns
    capsys.readouterr()
    main(common + ["--out_prefix", str(tmp_path / "s" / "stereo_rcnn_pgd"),
                   "--resume"])
    assert "losses" not in capsys.readouterr().out
    assert last.stat().st_mtime_ns == stamp


def _numpy_signs(traj):
    """A sweep's sign trajectory side as the CLI hands it to the replay
    (a tensor, or a collect="signs1" tuple of tensors) -> numpy."""
    if isinstance(traj, tuple):
        return tuple(t.numpy() for t in traj)
    return traj.numpy()


@pytest.mark.parametrize("detector", ["dsgn", "srcnn"])
def test_cli_signs_sweep_is_native_and_writes_the_jax_package_bytes(
        tmp_path, monkeypatch, capsys, detector):
    """The --transfer signs sweep of each detector replays through
    replay_sweep_u8 and writes through png_store_write only (the numpy
    replays and the zlib writer raise if reached), and writes the bytes of
    its --transfer full run and of the JAX package's replay and writer
    (its native sweep library) on the same packed signs."""
    from eval_driving_safety_tpu.attack import replay_native as JR
    from eval_driving_safety_tpu.data import dataset as jds

    from eval_driving_safety_tpu_torch.attack import pgd as P
    from eval_driving_safety_tpu_torch.attack import replay_native as R
    from eval_driving_safety_tpu_torch.data import dataset as D
    from eval_driving_safety_tpu_torch.data import png_store as PS
    ids = ["000001", "000002"]
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ids)
    n = 2

    def refuse(*a, **k):
        raise AssertionError("the sweep reached a plain version")
    for mod, name in ((P, "replay_pgd_255"), (P, "replay_pgd_ints"),
                      (P, "replay_pgd"), (K, "write_png")):
        monkeypatch.setattr(mod, name, refuse)
    calls = {"replay_sweep_u8": [], "png_store_write": 0}
    replay, png = R.replay_sweep_u8, PS.png_store_write

    def counted_replay(*a, **k):
        calls["replay_sweep_u8"].append(k.get("bits", 2))
        return replay(*a, **k)

    def counted_png(*a, **k):
        calls["png_store_write"] += 1
        return png(*a, **k)
    monkeypatch.setattr(R, "replay_sweep_u8", counted_replay)
    monkeypatch.setattr(PS, "png_store_write", counted_png)
    fetched = []
    fetch = D.fetch_packed_signs

    def recorded_fetch(pl, pr):
        fetched.append((_numpy_signs(pl), _numpy_signs(pr)))
        return fetch(pl, pr)
    monkeypatch.setattr(D, "fetch_packed_signs", recorded_fetch)

    prefix = "dsgn_pgd" if detector == "dsgn" else "stereo_rcnn_pgd"
    common = ["--data_path", data, "--detector", detector, "--iter", str(n),
              "--device", "cpu"] + (["--scale", "tiny"] if detector == "dsgn"
                                    else ["--tiny"])
    main(common + ["--out_prefix", str(tmp_path / "s" / prefix)])
    n_files = len(ids) * 2 * (n + 1)
    assert len(calls["replay_sweep_u8"]) == 2 * len(ids)
    assert calls["png_store_write"] == n_files
    if detector == "srcnn":
        assert "host replay path: native/int" in capsys.readouterr().out
    main(common + ["--out_prefix", str(tmp_path / "f" / prefix),
                   "--transfer", "full", "--sync_io"])
    assert calls["png_store_write"] == 2 * n_files
    files = _sweep_files(tmp_path / "s")
    assert len(files) == n_files and files == _sweep_files(tmp_path / "f")
    for rel in files:
        assert (tmp_path / "s" / rel).read_bytes() == \
            (tmp_path / "f" / rel).read_bytes(), rel

    # the JAX package's replay and writer on the signs the sweep fetched
    assert JR.get_native() is not None, "the JAX package's library"
    jset = jds.KittiStereoDataset(data)
    writer = jds.AsyncImageWriter(compress_level=0)
    jprefix = str(tmp_path / "j" / prefix)
    try:
        for i, (pl, pr) in enumerate(fetched):
            samples = [jset.get(i)]
            if detector == "dsgn":
                from eval_driving_safety_tpu.config import DSGNConfig
                b = jds.prepare_dsgn_batch_u8(samples,
                                              DSGNConfig.tiny().input)
                jds.save_sweep_from_signs(
                    b, b["im_left_u8"], b["im_right_u8"], pl, pr, jprefix,
                    lambda x: x, writer, alpha=1.0, eps=76.5, clip_min=0.0,
                    clip_max=255.0, space_255=True)
                continue
            b = jds.prepare_srcnn_batch_u8(samples,
                                           jds.SRCNNInputConfig(96, 320))
            v2l, v2r, q0l, q0r = jds.srcnn_cleanv_q0_host(b)
            jl, jr, bits = jds.fetch_packed_signs(pl, pr)
            K2 = b["den_h"].astype(np.int64) * b["den_w"]
            kw = dict(alpha2=2 * K2, eps2=153 * K2, max2=510 * K2,
                      c255=b["c255"], flip_channels=True, bits=bits)
            frames = zip(JR.replay_sweep_u8(v2l, jl, **kw),
                         JR.replay_sweep_u8(v2r, jr, **kw))
            jds.save_sweep(b, (q0l, q0r), frames, jprefix, lambda x: x,
                           writer)
    finally:
        writer.close()
    assert _sweep_files(tmp_path / "j") == files
    for rel in files:
        assert (tmp_path / "s" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel


def test_cli_srcnn_off_grid_step_replays_in_f32(tmp_path, capsys):
    """A step off the integer grid (--alpha 0.37 px) replays in f32, and
    still writes the bytes --transfer full writes."""
    data = str(tmp_path / "kitti")
    _kitti_dir(data, ["000001"])
    common = ["--data_path", data, "--detector", "srcnn", "--tiny",
              "--iter", "2", "--device", "cpu", "--alpha", "0.37"]
    main(common + ["--out_prefix", str(tmp_path / "s" / "p")])
    assert "host replay path: f32" in capsys.readouterr().out
    main(common + ["--out_prefix", str(tmp_path / "f" / "p"), "--transfer",
                   "full"])
    files = _sweep_files(tmp_path / "s")
    assert len(files) == 6 and files == _sweep_files(tmp_path / "f")
    for rel in files:
        assert (tmp_path / "s" / rel).read_bytes() == \
            (tmp_path / "f" / rel).read_bytes(), rel


def test_cli_srcnn_weights_uncert_and_fp32(tmp_path, capsys):
    """--ckpt: a port checkpoint directory's params and uncert, a state
    dict file, and the published .pth (its uncert; it was refused before
    the import was ported); --fp32 turns TF32 off."""
    import torch

    from eval_driving_safety_tpu_torch.cli.common import make_srcnn_model
    from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN
    from eval_driving_safety_tpu_torch.utils.checkpoint import \
        save_checkpoint
    cfg = StereoRCNNConfig.tiny()
    sd = StereoRCNN(cfg).init_weights(seed=5).state_dict()
    uncert = torch.arange(6, dtype=torch.float32) / 10
    save_checkpoint(str(tmp_path / "ck"), {"params": sd, "uncert": uncert})
    torch.save(sd, str(tmp_path / "sd.pt"))

    def load(path):
        return make_srcnn_model(argparse.Namespace(ckpt=path), cfg,
                                torch.device("cpu"))
    model, u = load(str(tmp_path / "ck"))
    assert torch.equal(u, uncert)
    assert torch.equal(model.state_dict()["rcnn.fc1.weight"],
                       sd["rcnn.fc1.weight"])
    model, u = load(str(tmp_path / "sd.pt"))
    assert not u.any()
    from test_torch_import import _synthetic_upstream_sd
    published = {"module." + k: torch.from_numpy(np.asarray(v))
                 for k, v in _synthetic_upstream_sd(cfg).items()}
    torch.save({"model": published, "uncert": uncert - 1},
               str(tmp_path / "published.pth"))
    capsys.readouterr()
    model, u = load(str(tmp_path / "published.pth"))
    assert torch.equal(u, uncert - 1)
    assert torch.equal(model.state_dict()["rcnn.cls_score.bias"],
                       published["module.RCNN_cls_score.bias"])
    assert "kpts convs=4, unmapped=0)" in capsys.readouterr().out

    data = str(tmp_path / "kitti")
    _kitti_dir(data, ["000001"])
    flags = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        main(["--data_path", data, "--detector", "srcnn", "--tiny", "--fp32",
              "--iter", "1", "--device", "cpu", "--ckpt",
              str(tmp_path / "ck"), "--out_prefix",
              str(tmp_path / "o" / "p")])
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    out = capsys.readouterr().out
    assert "uncert" in out and "losses" in out


@pytest.mark.parametrize("level", [0, 9])
def test_png_roundtrip_and_decoder_match_cv2(tmp_path, level):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    img[10:20] = img[10:11]                         # rows that filter well
    ours = str(tmp_path / "ours.png")
    K.write_png(ours, img, compress_level=level)
    theirs = str(tmp_path / "cv2.png")
    # cv2's encoder picks adaptive row filters (sub/up/average/paeth)
    cv2.imwrite(theirs, np.ascontiguousarray(img[..., ::-1]),
                [cv2.IMWRITE_PNG_COMPRESSION, 9])
    for path in (ours, theirs):
        with open(path, "rb") as f:
            assert np.array_equal(K.decode_png_rgb(f.read()), img), path
        assert np.array_equal(cv2.imread(path)[..., ::-1], img), path
