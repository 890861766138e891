"""The port's attack CLI end to end on CPU at the tiny scale, and its PNG
IO (exact comparisons: pixels are integers)."""
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


def test_cli_refuses_srcnn(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP"):
        main(["--data_path", str(tmp_path), "--detector", "srcnn"])


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
