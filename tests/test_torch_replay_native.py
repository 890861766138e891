"""The sweep's native host stages (attack/replay_native.py on
native/sweep_replay.cpp, data/png_store.py on native/png_store.cpp) byte
for byte against the JAX package's native functions and the port's numpy
plain versions, the wrappers' size checks, and the builds. The libraries
are built here with g++; a failed build fails."""
import zlib

import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.attack import replay_native as JR
from eval_driving_safety_tpu.data.exact_resize import \
    bilinear_axis_weights as j_weights

from eval_driving_safety_tpu_torch.attack import pgd as P
from eval_driving_safety_tpu_torch.attack import replay_native as R
from eval_driving_safety_tpu_torch.config import SRCNNInputConfig
from eval_driving_safety_tpu_torch.data import dataset as D
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.data import png_store as PS
from eval_driving_safety_tpu_torch.utils import native_build

# 9 x 1840 x 3 = 49,680 elements a sample: one whole 49,152-element tile
# of the C++ loop and a ragged one
SHAPE = (2, 9, 1840, 3)


def _signs(rng, iters, shape):
    """Seeded signs in {-1, 0, +1} (zero-free for 1-bit planes)."""
    return rng.randint(-1, 2, (iters, *shape)).astype(np.float32)


def _packed(s, bits):
    t = torch.from_numpy(s)
    if bits == 2:
        return P.pack_signs(t).numpy()
    return P.pack_bits(t > 0).numpy()


@pytest.mark.parametrize("bits", [2, 1])
@pytest.mark.parametrize("space", ["255", "v"])
def test_replay_matches_jax_native_and_the_numpy_replay(space, bits):
    rng = np.random.RandomState(4 + bits)
    s = _signs(rng, 3, SHAPE)
    if bits == 1:
        s[s == 0] = 1.0
    packed = _packed(s, bits)
    two_bit = packed if bits == 2 else P.signs1_to_packed2(packed)
    if space == "255":
        u8 = rng.randint(0, 256, SHAPE).astype(np.uint8)
        clean = u8.astype(np.int32)
        kw = dict(alpha2=2, eps2=153, max2=510, c255=1.0,
                  flip_channels=False)
        plain = [a for a, _ in P.replay_pgd_255(u8, u8, two_bit, two_bit,
                                                eps=76.5)]
    else:
        k = np.array([48, 80], np.int64)          # per-sample den_h * den_w
        clean = (rng.rand(*SHAPE) * 255 * k.reshape(2, 1, 1, 1)
                 ).astype(np.int32)
        c255 = (1.0 / k).astype(np.float32)
        kw = dict(alpha2=2 * k, eps2=5 * k, max2=510 * k, c255=c255,
                  flip_channels=True)
        plain = [D.quantize_v_rgb_u8(v2.astype(np.float32) * np.float32(0.5),
                                     c255)
                 for v2, _ in P.replay_pgd_ints(
                     clean * 2, clean * 2, two_bit, two_bit, alpha2=2 * k,
                     eps2=5 * k, clip_max2=510 * k)]
    got = R.replay_sweep_u8(clean, packed, bits=bits, **kw)
    want = JR.replay_sweep_u8(clean, packed, bits=bits, **kw)
    assert want is not None, "the JAX package's library"
    assert got.shape == (3, *SHAPE) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(plain))


def _samples(rng, sizes):
    out = []
    for i, (h, w) in enumerate(sizes):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        out.append(D.KittiSample(f"{i:06d}", im, im[:, ::-1].copy(),
                                 K.Calibration.default(), [], (h, w)))
    return out


# 75 -> 120 rows, scale 1.6: 260 -> 416 columns cropped at 400; 200 -> 320
# padded to 400
@pytest.mark.parametrize("sizes", [[(75, 260)], [(75, 200)],
                                   [(60, 250), (75, 260)]],
                         ids=["cropped", "padded", "mixed"])
def test_resize_q0_matches_jax_native_and_the_numpy_resize(sizes):
    rng = np.random.RandomState(5)
    b = D.prepare_srcnn_batch_u8(_samples(rng, sizes),
                                 SRCNNInputConfig(height=120, width=400))
    vl, vr, ql, qr = D.srcnn_cleanv_q0_host(b)
    plain_v = D.srcnn_cleanv_host(b)
    for side, (v, q) in enumerate(((vl, ql), (vr, qr))):
        np.testing.assert_array_equal(v, plain_v[side])
        np.testing.assert_array_equal(
            q, D.quantize_v_rgb_u8(plain_v[side].astype(np.float32),
                                   b["c255"]))
        np.testing.assert_array_equal(
            D.quantize_v_batch_u8(v, b["c255"]), q)
    key = ("im_left_u8", "im_right_u8")
    for i, (oh, ow) in enumerate(b["orig_hw"]):
        out_h, nw = b["net_hw"][i]
        full_w = int(round(ow * (out_h / oh)))
        for side, (v, q) in enumerate(((vl, ql), (vr, qr))):
            want = JR.resize_v2_q0(b[key[side]][i, :oh, :ow],
                                   j_weights(oh, out_h),
                                   j_weights(ow, full_w, crop=nw), 400,
                                   float(b["c255"][i]))
            assert want is not None, "the JAX package's library"
            np.testing.assert_array_equal(v[i], want[0])
            np.testing.assert_array_equal(q[i], want[1])
            np.testing.assert_array_equal(
                q[i], JR.quantize_v_u8(v[i], float(b["c255"][i]), True))


@pytest.mark.parametrize("view", ["whole", "cropped", "gray"])
def test_png_store_write_matches_jax_bytes_and_decodes(tmp_path, view):
    rng = np.random.RandomState(6)
    # 120 x 700 x 3 bytes a frame: scanlines straddle the 65,535-byte
    # stored blocks
    frame = rng.randint(0, 256, (130, 720, 3)).astype(np.uint8)
    arr = {"whole": frame, "cropped": frame[:120, :700],
           "gray": frame[:120, :700, 1]}[view]
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    PS.png_store_write(ours, arr)
    assert JR.png_store_write(theirs, arr)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    if view != "gray":
        np.testing.assert_array_equal(K.decode_png_rgb(data), arr)
        K.write_png(str(tmp_path / "z.png"), arr, compress_level=0)
        np.testing.assert_array_equal(
            K.decode_png_rgb(open(tmp_path / "z.png", "rb").read()), arr)


def _idat(data: bytes) -> bytes:
    """The concatenated IDAT payloads of a PNG."""
    out, pos = [], 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return b"".join(out)


@pytest.mark.parametrize("fill", [255, 254])
def test_png_store_write_holds_bright_rows_at_the_srcnn_size(tmp_path, fill):
    """A 600 x 1984 frame (5,953 bytes a scanline) with a band of rows of
    `fill`: the adler32 of the stored stream must stay exact, so that zlib
    inflates it, through the writer and through save_image's crop."""
    rng = np.random.RandomState(9)
    frame = rng.randint(0, 256, (640, 2000, 3)).astype(np.uint8)
    frame[100:400] = fill
    view = frame[:600, :1984]
    PS.png_store_write(str(tmp_path / "w.png"), view)
    K.save_image(str(tmp_path / "s.png"), frame, crop_hw=(600, 1984))
    for name in ("w.png", "s.png"):
        data = (tmp_path / name).read_bytes()
        raw = zlib.decompress(_idat(data))
        assert len(raw) == 600 * (1 + 1984 * 3)
        np.testing.assert_array_equal(K.decode_png_rgb(data), view)


def test_save_image_writes_native_at_level_0_and_zlib_above(tmp_path):
    rng = np.random.RandomState(7)
    # rows repeated 4 times: level 6 deflates them, level 0 stores them in
    # blocks that zlib's level 0 would split otherwise
    padded = np.repeat(rng.randint(0, 256, (50, 320, 3)), 4, axis=0
                       ).astype(np.uint8)
    K.save_image(str(tmp_path / "a" / "0.png"), padded, crop_hw=(190, 300))
    assert JR.png_store_write(str(tmp_path / "j.png"), padded[:190, :300])
    assert (tmp_path / "a" / "0.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    K.save_image(str(tmp_path / "a" / "6.png"), padded, crop_hw=(190, 300),
                 compress_level=6)
    data = (tmp_path / "a" / "6.png").read_bytes()
    assert len(data) < (tmp_path / "j.png").stat().st_size
    np.testing.assert_array_equal(K.decode_png_rgb(data), padded[:190, :300])


def _replay_args(packed_shape=(3, 2, 24), clean_shape=(2, 4, 8, 3)):
    return (np.zeros(clean_shape, np.int32),
            np.zeros(packed_shape, np.uint8))


_KW = dict(alpha2=2, eps2=153, max2=510, c255=1.0, flip_channels=False)


@pytest.mark.parametrize("case", ["packed_size", "bits1_plane", "params",
                                  "int32_range"])
def test_the_wrapper_refuses_arrays_that_do_not_fit(case, monkeypatch):
    """Each raises ValueError before the library is even loaded."""
    monkeypatch.setattr(R, "native", lambda: pytest.fail("reached C"))
    kw = dict(alpha2=2, eps2=153, max2=510, c255=1.0, flip_channels=False)
    clean, packed = _replay_args()
    if case == "packed_size":                 # a 1-bit plane read as 2-bit
        args, extra = (clean, packed[..., :12]), {}
    elif case == "bits1_plane":               # 5 x 3 = 15 signs a sample
        args = _replay_args((3, 2, 2), (2, 1, 5, 3))
        extra = {"bits": 1}
    elif case == "params":
        args, extra = (clean, packed), {"eps2": np.array([1, 2, 3])}
    else:
        args, extra = (clean, packed), {"max2": np.array([510, 2 ** 31])}
    with pytest.raises(ValueError):
        R.replay_sweep_u8(*args, **{**kw, **extra})


def test_a_failed_allocation_and_a_failed_open_raise(tmp_path, monkeypatch):
    class NoMemory:
        def replay_sweep_u8(self, *args):
            return 1
    clean, packed = _replay_args()
    kw = dict(alpha2=2, eps2=153, max2=510, c255=1.0, flip_channels=False)
    with monkeypatch.context() as m:
        m.setattr(R, "native", NoMemory)
        with pytest.raises(MemoryError):
            R.replay_sweep_u8(clean, packed, **kw)
    with pytest.raises(OSError, match="cannot open"):
        PS.png_store_write(str(tmp_path / "no" / "such" / "dir.png"),
                          np.zeros((4, 4, 3), np.uint8))


def test_a_sweep_library_that_cannot_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(R, "_lib", None)
    monkeypatch.setattr(R, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(R, "CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="cannot build the sweep replay"):
        R.replay_sweep_u8(*_replay_args(), **_KW)
    assert not list(tmp_path.iterdir())


def test_a_png_library_that_cannot_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PS, "_lib", None)
    monkeypatch.setattr(PS, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(PS, "CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="cannot build the PNG writer"):
        PS.png_store_write(str(tmp_path / "x.png"),
                           np.zeros((4, 4, 3), np.uint8))
    assert not list(tmp_path.iterdir())


def test_a_sweep_library_that_cannot_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(R, "_lib", None)
    monkeypatch.setattr(R, "BUILD_DIR", tmp_path)
    native_build.library_path(R.SOURCE, tmp_path, R.CXX, R.CXX_FLAGS
                              ).write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load the sweep replay"):
        R.replay_sweep_u8(*_replay_args(), **_KW)


def test_the_sweep_library_builds_into_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(R, "_lib", None)
    monkeypatch.setattr(R, "BUILD_DIR", tmp_path)
    clean, packed = _replay_args()
    packed[:] = 0b10101010               # sign +1 everywhere: 1, 2, 3
    out = R.replay_sweep_u8(clean, packed, **_KW)
    np.testing.assert_array_equal(
        out, np.broadcast_to(np.arange(1, 4, dtype=np.uint8)[:, None, None,
                                                              None, None],
                             out.shape))
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
    assert next(tmp_path.iterdir()).name.startswith("sweep_replay-")


def test_a_march_native_library_is_named_by_the_host_target(tmp_path,
                                                            monkeypatch):
    """A library built with -march=native runs only where those
    instructions exist: its name hashes what -march=native resolves to,
    so a build directory carried to another CPU is not loaded there."""
    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    names = set()
    for target in ("-march= sapphirerapids", "-march= znver4"):
        monkeypatch.setattr(native_build, "native_target",
                            lambda cxx, t=target: t)
        names.add(native_build.library_path(src, tmp_path, "g++",
                                            native_build.TUNED_FLAGS))
    assert len(names) == 2
    monkeypatch.setattr(native_build, "native_target",
                        lambda cxx: pytest.fail("asked without the flag"))
    native_build.library_path(src, tmp_path, "g++", ("-O3", "-shared"))


def test_png_writes_from_many_threads_at_once(tmp_path):
    """The writer keeps one buffer per thread: frames of several sizes
    written from more threads than cores at once each decode to their
    own pixels."""
    import os
    import sys
    import threading
    rng = np.random.RandomState(8)
    frames = [rng.randint(0, 256, (20 + 7 * i, 30 + 5 * i, 3)).astype(
        np.uint8) for i in range(min(2 * (os.cpu_count() or 1), 128))]
    errors = []

    def write(i):
        try:
            for k in range(3):
                PS.png_store_write(str(tmp_path / f"{i}_{k}.png"),
                                   frames[i])
        except Exception as e:                       # noqa: BLE001
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(i,))
                   for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for i, frame in enumerate(frames):
        for k in range(3):
            data = (tmp_path / f"{i}_{k}.png").read_bytes()
            np.testing.assert_array_equal(K.decode_png_rgb(data), frame)
