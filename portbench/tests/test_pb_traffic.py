"""The traffic generator is deterministic per seed, every seed makes the
same amount of work, and the PNG codec round-trips."""
import os

import numpy as np

from portbench import frames, png

SPEC = dict(pairs=4, height=45, width=120, cars=[2, 4], split_ids=12,
            png_level=0)


def files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_same_seed_same_bytes(tmp_path):
    big = 2 ** 31 + 12345
    a = frames.make_traffic(str(tmp_path / "a"), big, SPEC)
    b = frames.make_traffic(str(tmp_path / "b"), big, SPEC)
    assert files(tmp_path / "a") == files(tmp_path / "b")
    assert a.ids == b.ids and len(a.ids) == SPEC["split_ids"]
    c = frames.make_traffic(str(tmp_path / "c"), big + 1, SPEC)
    assert not np.array_equal(a.left[0], c.left[0])
    # the same sizes and the same number of Cars, in another order
    assert sorted(map(len, a.cars)) == sorted(map(len, c.cars))
    assert all(x.shape == (45, 120, 3) for x in a.left + c.right)


def test_split_ids_are_links_onto_the_pairs(tmp_path):
    t = frames.make_traffic(str(tmp_path), 7, SPEC)
    for j, fid in enumerate(t.ids):
        k = t.pair_of[fid]
        assert k == j % SPEC["pairs"]
        got = png.read(os.path.join(t.root, "image_3", fid + ".png"))
        assert np.array_equal(got, t.right[k])
        with open(os.path.join(t.root, "label_2", fid + ".txt")) as f:
            lines = f.read().splitlines()
        assert lines == [c.line() for c in t.cars[k]]


def test_png_round_trip_and_filters():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    for level in (0, 6):
        assert np.array_equal(png.decode(png.encode(img, level)), img)


def test_the_port_reads_the_frames(tmp_path):
    from eval_driving_safety_tpu_torch.data import kitti
    t = frames.make_traffic(str(tmp_path), 3, SPEC)
    fid = t.ids[5]
    got = kitti.load_image_u8(os.path.join(t.root, "image_2", fid + ".png"))
    assert np.array_equal(got, t.left[t.pair_of[fid]])
    objs = kitti.read_label(os.path.join(t.root, "label_2", fid + ".txt"))
    cars = t.cars[t.pair_of[fid]]
    assert [tuple(o.location) for o in objs] == [c.loc for c in cars]
    assert [tuple(o.bbox) for o in objs] == [c.bbox for c in cars]
