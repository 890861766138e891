"""The batch split over torch.distributed (parallel/sharding.py) on the
CPU with gloo: the torchrun environment, the split's rule, the twins of
tests/test_parallel.py's sharded PGD and patch steps against the JAX
functions on a 2-device mesh, and both detectors' PGD sweeps and patch
CLIs at world size 2 against world size 1.

The ranks are subprocesses with the torchrun environment
(chip_smoke.launch_ranks: a free localhost port, one retry if it was
taken, every process killed at the timeout); a rank that exits non-zero
fails the test."""
import concurrent.futures as cf
import datetime
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as R
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.parallel import sharding as S

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# two intra-op threads a process, the same in every run compared
ENV = dict(os.environ, OMP_NUM_THREADS="2")
TIMEOUT = 180


def launch(world, argv):
    results = chip_smoke.launch_ranks(world, argv, TIMEOUT, env=ENV,
                                      cwd=str(ROOT))
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {rank} of {world} exited {rc}:\n{err[-3000:]}"
    return [out for _, out, _ in results]


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in chip_smoke.RANK_ENV:
        monkeypatch.delenv(k, raising=False)


# ----- the environment and the rule -----

def test_without_torchrun_the_world_is_one_process(no_torchrun):
    mesh = S.init_process_group("cpu")
    try:
        assert mesh == S.Mesh(1, 0, torch.device("cpu"))
        assert not dist.is_initialized()
        assert S.make_mesh() == mesh and S.make_mesh(1, 1) == mesh
        sharding = S.dp_sharding(mesh, 4)
        assert not sharding.split and sharding.writes
        x = torch.arange(6.0)
        with sharding:
            assert S.global_sum(x) is x
            assert S.gather_rows(x) is x
            assert S.is_first_share()
            assert torch.equal(S.global_mean(x), x.mean())
    finally:
        S.destroy_process_group()


@pytest.mark.parametrize("present", [("WORLD_SIZE",), ("RANK", "LOCAL_RANK"),
                                     ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                                      "MASTER_ADDR")])
def test_a_partial_torchrun_environment_raises(no_torchrun, monkeypatch,
                                               present):
    for k in present:
        monkeypatch.setenv(k, "127.0.0.1" if k == "MASTER_ADDR" else "0")
    with pytest.raises(RuntimeError, match="partial torchrun environment"):
        S.init_process_group("cpu")
    assert not dist.is_initialized()


def test_a_failed_init_raises(no_torchrun, monkeypatch):
    """Rank 1 of 2 with no rank 0 listening: the init raises, and no
    group of one process takes its place."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(chip_smoke.free_port()))
    with pytest.raises(Exception):
        S.init_process_group("cpu", timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()
    assert S.make_mesh() == S.Mesh()


def test_make_mesh_refuses_the_model_axis(no_torchrun):
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        S.make_mesh(1, 2)
    with pytest.raises(ValueError, match="world of 1"):
        S.make_mesh(2, 1)


def test_the_split_takes_contiguous_rows_or_replicates():
    from eval_driving_safety_tpu_torch.models.stereo_targets import \
        SamplingDraws
    mesh = S.Mesh(2, 1, torch.device("cpu"))
    split = S.dp_sharding(mesh, 4)
    assert split.split and split.rows == slice(2, 4) and split.writes
    draws = SamplingDraws(*(torch.arange(4.0 * k, 4.0 * k + 4)[:, None]
                            for k in range(4)))
    tree = {"a": np.arange(8).reshape(4, 2), "ids": ["w", "x", "y", "z"],
            "t": (torch.arange(4), 3.0), "table": np.zeros(3),
            "scalar": np.float32(2.0), "draws": draws}
    got = S.shard_batch(tree, split)
    assert got["a"].tolist() == [[4, 5], [6, 7]]
    assert got["ids"] == ["y", "z"] and got["t"][1] == 3.0
    assert got["t"][0].tolist() == [2, 3] and got["table"].shape == (3,)
    assert isinstance(got["draws"], SamplingDraws)
    assert got["draws"].roi_bg[:, 0].tolist() == [14.0, 15.0]
    # 3 rows do not divide by 2: every rank keeps the batch, rank 0 writes
    whole = S.dp_sharding(mesh, 3)
    assert not whole.split and not whole.writes
    assert S.shard_batch(tree, whole) is tree
    assert S.dp_sharding(S.Mesh(2, 0), 3).writes


def test_losses_at_world_one_keep_their_expressions():
    """One process: the Stereo R-CNN loss adds every term as before the
    split existed, bit for bit."""
    from eval_driving_safety_tpu_torch.models.stereo_rcnn import (
        LOSS_NAMES, total_attack_loss)
    g = torch.Generator().manual_seed(0)
    losses = {k: torch.rand((), generator=g) * 10 for k in LOSS_NAMES}
    uncert = torch.randn(6, generator=g)
    want = torch.zeros(())
    for i, k in enumerate(LOSS_NAMES):
        want = want + losses[k] * torch.exp(-uncert[i]) + uncert[i]
    assert torch.equal(total_attack_loss(losses, uncert), want)


# ----- the twins of tests/test_parallel.py -----

@pytest.fixture(scope="module")
def twin_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("twins") / "rank{rank}.npz"
    launch(2, [sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
               str(out)])
    return [dict(np.load(str(out).replace("{rank}", str(r))))
            for r in range(2)]


def _jax_pgd(loss):
    import jax.numpy as jnp
    from eval_driving_safety_tpu.parallel.sharding import (
        make_mesh, shard_batch, sharded_pgd_step)
    mesh = make_mesh(2, 1)
    left, right = R.pgd_inputs()
    step = sharded_pgd_step(loss, mesh, **R.PGD)
    with mesh:
        b = shard_batch({"l": jnp.asarray(left), "r": jnp.asarray(right)},
                        mesh)
        al, ar, l0 = step(b["l"], b["r"], b["l"], b["r"])
    return np.asarray(al), np.asarray(ar), float(l0)


def test_sharded_pgd_matches_single_device(twin_ranks):
    """Twin of tests/test_parallel.py's test: the ranks' rows are the JAX
    step's on the 2-device mesh, and the loss is the whole batch's."""
    al, ar, loss = _jax_pgd(R.square_loss)
    np.testing.assert_array_equal(
        np.concatenate([t["square_l"] for t in twin_ranks]), al)
    np.testing.assert_array_equal(
        np.concatenate([t["square_r"] for t in twin_ranks]), ar)
    for t in twin_ranks:
        np.testing.assert_allclose(t["square_loss"], loss, rtol=1e-6)


def test_sharded_pgd_takes_the_batchs_normalizers(twin_ranks):
    """A loss of two terms over two batch counts: with the counts summed
    over the ranks, the step is JAX's, pixel for pixel; with each rank's
    own counts it is not."""
    import jax.numpy as jnp

    def loss(l, r):
        return R.coupled_loss(l, r, clamp=lambda n: jnp.maximum(n, 1.0))
    al, ar, l0 = _jax_pgd(loss)
    got_l = np.concatenate([t["coupled_l"] for t in twin_ranks])
    got_r = np.concatenate([t["coupled_r"] for t in twin_ranks])
    np.testing.assert_array_equal(got_l, al)
    np.testing.assert_array_equal(got_r, ar)
    for t in twin_ranks:
        np.testing.assert_allclose(t["coupled_loss"], l0, rtol=1e-5)
    per_rank = np.concatenate([t["per_rank_l"] for t in twin_ranks])
    assert (per_rank != al).sum() > 0


def test_sharded_patch_grad_is_batch_sum(twin_ranks):
    """Twin of tests/test_parallel.py's test: the patch gradient is the
    sum over both ranks' rows. The ranks hold the same bits, those of one
    process (the rows' gradients are added in the batch's order), and
    JAX's patch within 1e-6."""
    import jax
    import jax.numpy as jnp
    from eval_driving_safety_tpu.parallel.sharding import (
        make_mesh, replicated, shard_batch, sharded_patch_step)
    from eval_driving_safety_tpu_torch.attack.patch import patch_update_step
    imgs_l, imgs_r, patch, cl, cr = R.patch_inputs()
    mesh = make_mesh(2, 1)
    step = sharded_patch_step(
        lambda l, r: R.patch_loss(l, r, clamp=lambda n: jnp.maximum(n, 1.)),
        mesh, **R.PATCH)
    with mesh:
        b = shard_batch({"il": imgs_l, "ir": imgs_r, "cl": cl, "cr": cr},
                        mesh)
        p = jax.device_put(jnp.asarray(patch), replicated(mesh))
        want, l0 = step(p, b["il"], b["ir"], b["cl"], b["cr"])
    one, one_loss = patch_update_step(
        R.patch_loss, torch.from_numpy(patch), torch.from_numpy(imgs_l),
        torch.from_numpy(imgs_r), cl, cr, **R.PATCH)
    r0, r1 = (t["patch"] for t in twin_ranks)
    assert r0.tobytes() == r1.tobytes() == one.numpy().tobytes()
    np.testing.assert_allclose(r0, np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not np.allclose(r0, patch)
    for t in twin_ranks:
        np.testing.assert_allclose(t["patch_loss"], float(l0), rtol=1e-6)
    np.testing.assert_allclose(float(one_loss), float(l0), rtol=1e-6)


# ----- the CLIs at world size 2 against world size 1 -----

CALIB = ("P2: 180.0 0.0 160.0 11.2 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n"
         "P3: 180.0 0.0 160.0 -86.0 0.0 180.0 48.0 0.05 0.0 0.0 1.0 0.003\n")
LABEL = "Car 0.00 0 -1.58 100.0 40.0 160.0 80.0 1.5 1.7 4.0 2.0 1.6 18.0 0.4\n"
# three frames of three sizes: at --batch 2 the first two are split over
# two ranks (the Stereo R-CNN batch pads them to the larger), the third
# is a short last batch that every rank computes whole
FRAMES = (("000001", (90, 300)), ("000002", (84, 292)), ("000003", (88, 310)))
PGD_MODULE = "eval_driving_safety_tpu_torch.cli.pgd_attack"
PATCH_MODULE = "eval_driving_safety_tpu_torch.cli.patch_attack"


def write_frames(root):
    """The frames, and DSGN depth ground truth (`depth/`) valid on another
    share of each frame's pixels, so that the disparity term's count and
    the 3D-RPN's differ from rank to rank."""
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2", "depth"):
        os.makedirs(os.path.join(root, sub))
    for (fid, hw), share in zip(FRAMES, (0.2, 0.7, 0.5)):
        depth = rng.uniform(2.5, 55.0, hw) * (rng.rand(*hw) < share)
        np.save(os.path.join(root, "depth", fid + ".npy"),
                depth.astype(np.float32))
        left = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        K.write_png(os.path.join(root, "image_2", fid + ".png"), left)
        K.write_png(os.path.join(root, "image_3", fid + ".png"),
                    np.roll(left, -5, axis=1))
        with open(os.path.join(root, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(root, "label_2", fid + ".txt"), "w") as f:
            f.write(LABEL)


def _scale(detector):
    return ["--scale", "tiny"] if detector == "dsgn" else ["--tiny"]


# the sweeps' iterations. The split rows differ from the batch's in a
# few pixels at iteration 1 (the CPU's kernels round otherwise at batch 1
# than at batch 2,
# test_sweep_at_world_2_differs_only_where_the_batched_forward_rounds),
# and a later iteration starts from those iterates: one iteration is the
# whole of what a world-1 test can predict
ITERS = 1
# name: (world, module, arguments after --data_path; "OUT" is the run's
# directory)
RUNS = {
    **{f"{det}_{tr}_w{w}": (w, PGD_MODULE, [
        "--detector", det, *_scale(det), "--iter", str(ITERS),
        "--batch", "2", "--transfer", tr, "--out_prefix", "OUT/pgd",
        *(["--depth_dir", "DATA/depth"] if det == "dsgn" else [])])
       for det in ("dsgn", "srcnn") for tr in ("signs", "full")
       for w in (1, 2)},
    **{f"{det}_patch_w{w}": (w, PATCH_MODULE, [
        "--detector", det, *_scale(det), "--epochs", "1", "--iters", "2",
        "--batch", "2", "--save_dir", "OUT/patch"])
       for det in ("dsgn", "srcnn") for w in (1, 2)},
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every run of RUNS, four launches at a time: {name: (directory,
    each rank's report, each rank's stdout)}."""
    tmp = tmp_path_factory.mktemp("cli")
    data = str(tmp / "kitti")
    write_frames(data)

    def run(name):
        world, module, args = RUNS[name]
        out = tmp / name
        out.mkdir()
        outs = launch(world, [
            sys.executable, str(ROOT / "chip_smoke.py"), "--rank-run",
            str(out / "report{rank}.json"), module, "--data_path", data,
            "--device", "cpu", *(a.replace("OUT", str(out)).replace(
                "DATA", data) for a in args)])
        reports = [json.load(open(out / f"report{r}.json"))
                   for r in range(world)]
        return out, reports, outs
    with cf.ThreadPoolExecutor(4) as ex:
        return dict(zip(RUNS, ex.map(run, RUNS)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith((".png", ".npy")))


def _writes_by_rank(reports):
    """{rank: {file name: writes}} of a run's reports."""
    return {r["rank"]: r["writes"] for r in reports}


def _losses(stdout):
    return [ln for ln in stdout.splitlines() if "losses" in ln
            or "avg loss" in ln]


def _sweep_written_once(run, iters):
    """Every PNG of the sweep was written once in all: frames 000001 and
    000002 (the split batch) by ranks 0 and 1, 000003 (the short last
    batch, computed whole by both) by rank 0 alone."""
    out, reports, _ = run
    writes = _writes_by_rank(reports)
    n_files = 2 * (iters + 1)
    for rank, fids in ((0, ("000001", "000003")), (1, ("000002",))):
        assert sorted(writes[rank].values()) == [1] * n_files * len(fids)
        assert sorted(os.path.basename(p) for p in writes[rank]) == sorted(
            f + ".png" for f in fids for _ in range(n_files))
    assert not set(writes[0]) & set(writes[1])


@pytest.mark.parametrize("detector", ["dsgn", "srcnn"])
@pytest.mark.parametrize("transfer", ["signs", "full"])
def test_sweep_at_world_2_differs_only_where_the_batched_forward_rounds(
        cli_runs, detector, transfer):
    """Each detector's sweep at world size 2 writes world size 1's files,
    each once, but for the pixels of iteration 1 where one process's
    first step already differs between the rows computed as a batch of 2
    and each row alone with the batch's normalizers: the CPU's kernels
    round otherwise at batch 1 than at batch 2 (Stereo R-CNN: a 3x3
    stride-2 conv of the tiny ResNet's last stage). That first step
    predicts both runs' iteration-1 frames exactly: the batch's is world
    size 1's, the rows' world size 2's. The pixels where they differ are
    the bound, counted here. Frame 000003, the short last batch, is
    computed whole at either world size, and its files are the same
    bytes."""
    one, _, one_out = cli_runs[f"{detector}_{transfer}_w1"]
    two, _, two_out = run = cli_runs[f"{detector}_{transfer}_w2"]
    files = _files(one)
    assert files == _files(two) and len(files) == 3 * 2 * 2
    data = str(one.parent / "kitti")
    threads = torch.get_num_threads()
    torch.set_num_threads(int(ENV["OMP_NUM_THREADS"]))
    try:
        first = chip_smoke.first_step_frames(
            chip_smoke.dsgn_first_step(data, torch.device("cpu"), "tiny",
                                       os.path.join(data, "depth"))
            if detector == "dsgn" else
            chip_smoke.srcnn_first_step(data, torch.device("cpu"), tiny=True))
    finally:
        torch.set_num_threads(threads)
    differing = 0
    for f in files:
        a, b = (K.load_image_u8(str(d / f)) for d in (one, two))
        fid = os.path.basename(f)[:-4]
        if "iters_1" not in f or fid == "000003":
            assert a.tobytes() == b.tobytes(), f
            continue
        # one process wrote the batch's first iterate, the ranks the rows'
        batched, alone = first[(fid, "image_3" in f)]
        np.testing.assert_array_equal(a, batched, err_msg=f)
        np.testing.assert_array_equal(b, alone, err_msg=f)
        differing += int((a != b).any(-1).sum())
    print(f"{detector} {transfer}: {differing} pixels of iteration 1 "
          "differ")
    _sweep_written_once(run, ITERS)
    # rank 0 alone logs the global batch's losses
    assert not two_out[1]
    np.testing.assert_allclose(_numbers(two_out[0]), _numbers(one_out[0]),
                               rtol=1e-4)


def _numbers(stdout):
    """The losses that a run logged, in order."""
    return [float(v) for ln in _losses(stdout)
            for v in re.findall(r"-?\d+\.\d+", ln.split("loss")[-1])]


# Stereo R-CNN's patch at world size 2 against world size 1: its rows'
# gradients round otherwise at batch 1 than at batch 2 (as its sweep's
# do), and where 0.5 * alpha * g is not clamped to +-eps the patch takes
# that rounding. At most 2% of the entries may differ, each by at most
# 0.02, a tenth of what 2 steps of eps 0.1 may move an entry (this CPU:
# none on these frames, 1 of 243 entries by 0.0095 on frames seeded
# otherwise). DSGN's patch is world size 1's bit for bit.
SRCNN_PATCH_ATOL, SRCNN_PATCH_SHARE = 0.02, 0.02


@pytest.mark.parametrize("detector", ["dsgn", "srcnn"])
def test_patch_at_world_2_matches_world_1(cli_runs, detector):
    one, _, one_out = cli_runs[f"{detector}_patch_w1"]
    two, reports, two_out = cli_runs[f"{detector}_patch_w2"]
    assert _files(one) == _files(two) == ["patch/epoch0/patch.npy",
                                          "patch/epoch1/patch.npy"]
    want = np.load(one / "patch" / "epoch1" / "patch.npy")
    got = np.load(two / "patch" / "epoch1" / "patch.npy")
    # every rank holds the same bits, which rank 0 wrote, once
    ranks = [np.asarray(r["patch"][0], np.float32) for r in reports]
    assert ranks[0].tobytes() == ranks[1].tobytes()
    assert got[0].transpose(1, 2, 0).tobytes() == ranks[0].tobytes()
    writes = _writes_by_rank(reports)
    assert sorted(os.path.relpath(p, two) for p in writes[0]) == _files(two)
    assert set(writes[0].values()) == {1} and not writes[1]
    assert not np.array_equal(want, np.load(one / "patch" / "epoch0" /
                                            "patch.npy"))
    print(f"{detector} patch: {int((got != want).sum())} of {got.size} "
          f"entries differ, by at most {np.abs(got - want).max()}")
    if detector == "dsgn":
        assert got.tobytes() == want.tobytes()
        assert _losses(two_out[0]) == _losses(one_out[0])
    else:
        assert np.abs(got - want).max() <= SRCNN_PATCH_ATOL
        assert (got != want).mean() <= SRCNN_PATCH_SHARE
        np.testing.assert_allclose(_numbers(two_out[0]),
                                   _numbers(one_out[0]), rtol=1e-4)
    assert not two_out[1] and len(_losses(two_out[0])) == 1


def test_resume_decides_on_the_global_batches(cli_runs, tmp_path):
    """--resume at world size 2 after a run that lost one file of frame
    000002's last iteration: both ranks redo the split batch (000001,
    000002), each writing its frame's files again, the same bytes, and
    skip the short last batch, which was done."""
    import shutil
    src, _, _ = cli_runs["dsgn_signs_w2"]
    out = tmp_path / "resume"
    shutil.copytree(src, out)
    lost = out / f"pgd_iters_{ITERS}" / "image_2" / "000002.png"
    lost.unlink()
    world, module, args = RUNS["dsgn_signs_w2"]
    launch(2, [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-run",
               str(out / "report{rank}.json"), module, "--data_path",
               str(src.parent / "kitti"), "--device", "cpu", "--resume",
               *(a.replace("OUT", str(out)).replace(
                   "DATA", str(src.parent / "kitti")) for a in args)])
    writes = _writes_by_rank(json.load(open(out / f"report{r}.json"))
                             for r in range(2))
    for rank, fid in ((0, "000001"), (1, "000002")):
        assert sorted(os.path.basename(p) for p in writes[rank]) == \
            [fid + ".png"] * 2 * (ITERS + 1)
        assert set(writes[rank].values()) == {1}
    assert _files(out) == _files(src)
    for f in _files(src):
        assert (out / f).read_bytes() == (src / f).read_bytes(), f
