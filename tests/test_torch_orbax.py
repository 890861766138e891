"""The port's reader of the JAX trainers' orbax checkpoints
(utils/orbax_read.py, utils/zstd.py) and its optimizer-state conversion,
on the CPU: the reader against orbax's restore on every leaf type and on
the committed fixture (the JAX DSGN trainer's `--tiny` epoch, which
chip_smoke.py phase 14 reads on the card's machine), the OCDBT B-tree and
zarr chunks against tensorstore, zstd against zstandard, the refusals;
the optax state converted and continued against optax. The helpers here
also serve tests/test_torch_orbax_{dsgn,srcnn,classifiers}.py, where each
JAX trainer writes its checkpoints and the port's consumers read them
(one file each, so that the suite's workers share them out).

Tolerances: the reader bit for bit (bfloat16 by its bits); the optimizer
state's conversion within 1e-6, the tolerance of tests/test_torch_train.py's
`test_detector_optimizer_matches_optax`.
"""
import ctypes.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard

import chip_smoke
from eval_driving_safety_tpu.cli import train_detector as jax_train
from eval_driving_safety_tpu.utils.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from eval_driving_safety_tpu_torch.cli import train_detector as T
from eval_driving_safety_tpu_torch.utils import checkpoint as C
from eval_driving_safety_tpu_torch.utils import orbax_read as R
from eval_driving_safety_tpu_torch.utils import zstd
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax

IDS = ["000001", "000002"]
FIXTURE = os.path.join(chip_smoke.ROOT, chip_smoke.ORBAX_FIXTURE)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these modules: the suite runs a
    worker per core, where torch's default pool of a thread per core
    waits on descheduled threads at every small op of the tiny models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A restored JAX tree with its arrays as numpy (bfloat16 kept)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _assert_same_tree(got, want, path="tree"):
    """read_orbax's tree against orbax's restore: the same containers,
    None leaves, scalars of the same type, arrays of the same dtype,
    shape and bytes (bfloat16 as torch.bfloat16 with the same bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, (bool, int, float, str)):
        assert type(got) is type(want) and got == want, path
    else:
        want = np.asarray(want)
        if str(want.dtype) == "bfloat16":
            assert isinstance(got, torch.Tensor), path
            assert got.dtype == torch.bfloat16, path
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path

def _bridged(tmp_path, tree, params):
    """The port's checkpoint of `params` (a state dict bridged from the
    JAX package's restore), beside the tree's `uncert` if it has one."""
    out = str(tmp_path / "bridged")
    C.save_checkpoint(out, {"params": params, "epoch": int(tree["epoch"]),
                            **({"uncert": torch.tensor(np.asarray(
                                tree["uncert"]))} if "uncert" in tree
                               else {})})
    return out


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            if name != "metrics.jsonl":
                with open(os.path.join(d, name), "rb") as f:
                    out[os.path.relpath(os.path.join(d, name), root)] = \
                        f.read()
    return out


def _both(tmp_path, ckpts, run):
    """`run(ckpt, out_dir)` on the orbax directory and on the bridged
    checkpoint: the files each wrote, and the losses each printed."""
    outs = []
    for name, ckpt in ckpts.items():
        out = str(tmp_path / f"out_{name}")
        printed = run(ckpt, out)
        outs.append((_files(out), [ln for ln in printed.splitlines()
                                   if "loss" in ln]))
    return outs

# ------------------------------------------------------------------ reader


def test_read_orbax_equals_restore_on_every_leaf_type(tmp_path):
    """bfloat16 (an array and a scalar), float16, the integer widths,
    bools, Python scalars, a string, None, empty containers, tuples and a
    value too large to be inline in the B-tree."""
    rng = np.random.RandomState(0)
    tree = {
        "bf16": jnp.asarray(rng.randn(5, 7), jnp.bfloat16),
        "bf16_scalar": jnp.asarray(-3.25, jnp.bfloat16),
        "f16": jnp.asarray(rng.randn(2, 3), jnp.float16),
        "big": jnp.asarray(rng.randn(300, 200).astype(np.float32)),
        "ints": [np.arange(5, dtype=np.int64), np.arange(3, dtype=np.uint8),
                 jnp.arange(4, dtype=jnp.int32)],
        "mask": np.array([True, False, True]),
        "scalars": {"i": 7, "f": 1.5, "b": True, "np": np.float32(2.5)},
        "name": "epoch",
        "empty": {"d": {}, "l": [], "n": None},
        "tuple": (jnp.ones(2), None),
    }
    save_checkpoint(str(tmp_path / "ck"), tree)
    got = R.read_orbax(str(tmp_path / "ck"))
    _assert_same_tree(got, restore_checkpoint(str(tmp_path / "ck")))
    assert got["bf16"].dtype == torch.bfloat16


def test_the_committed_fixture_restores_to_its_digests():
    """tests/torch_fixtures/orbax_dsgn_tiny (the JAX DSGN trainer's
    --tiny epoch; chip_smoke.py phase 14 reads it on the card's machine):
    orbax's restore and the port's reader give its digests."""
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        want = json.load(f)
    path = C.latest_epoch_dir(FIXTURE)
    assert C.is_orbax_checkpoint(path)
    assert chip_smoke.leaf_digests(_np(restore_checkpoint(path))) == want
    tree = R.read_orbax(path)
    assert chip_smoke.leaf_digests(tree) == want
    sd = dsgn_state_dict_from_flax(tree["params"])
    assert sum(v.numel() for v in sd.values()) == 59901


def test_b_tree_of_several_levels_reads_as_tensorstore(tmp_path):
    """An OCDBT store whose nodes hold a few entries (interior nodes
    above the leaves, values inline and in data files, many versions):
    every key and value as tensorstore reads them."""
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 300,
                   "max_inline_value_bytes": 16,
                   "version_tree_arity_log2": 2}}).result()
    rng = np.random.RandomState(1)
    for i in rng.permutation(60):
        kv.write(b"k%03d/x" % i, rng.bytes(5 + i)).result()
    store = R._Store(str(tmp_path))
    keys = kv.list().result()
    assert sorted(store.values) == sorted(keys) and len(keys) == 60
    for k in keys:
        assert store.get(k.decode()) == kv.read(k).result().value


ARRAYS = {  # name: dtype, fill value, shape, chunks
    "grid": ("<f4", None, (5, 7), (2, 3)),
    "filled": ("<i8", 3, (9,), (4,)),
    "bf16": ("bfloat16", 1.5, (3, 4), (2, 2)),
    "big_endian": (">f8", None, (4,), (4,)),
}


@pytest.fixture(scope="module")
def zarr_store(tmp_path_factory):
    """ARRAYS written by tensorstore into one OCDBT store, each with its
    upper half's chunks never written."""
    root = tmp_path_factory.mktemp("zarr")
    base = {"driver": "ocdbt", "base": f"file://{root}/"}
    for name, (dt, fill, shape, chunks) in ARRAYS.items():
        t = ts.open({"driver": "zarr", "kvstore": {**base, "path": name + "/"},
                     "metadata": {"dtype": dt, "shape": list(shape),
                                  "chunks": list(chunks), "fill_value": fill,
                                  "compressor": {"id": "zstd", "level": 1},
                                  "dimension_separator": "."},
                     "create": True}).result()
        v = np.arange(np.prod(shape)).reshape(shape) * 1.25
        h = shape[0] // 2 + 1
        t[:h].write(v[:h].astype(t.dtype.numpy_dtype)).result()
    return root, base


@pytest.mark.parametrize("name", ARRAYS)
def test_zarr_chunks_and_fill_read_as_tensorstore(zarr_store, name):
    """A chunk grid with ragged edges, chunks never written taking the
    fill value (null reads as 0), bfloat16 and big-endian data, as
    tensorstore reads them; a store that says every chunk was written
    refuses a missing one by name."""
    root, base = zarr_store
    want = ts.open({"driver": "zarr", "kvstore": {
        **base, "path": name + "/"}}).result().read().result()
    store = R._Store(str(root))
    got = R._read_array(store, name, chunks_written=False)
    if isinstance(got, torch.Tensor):
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    assert got.dtype == want.dtype.newbyteorder("=")
    assert np.array_equal(got, want)
    if name != "big_endian":                  # its one chunk is written
        with pytest.raises(ValueError, match="missing chunk"):
            R._read_array(store, name, chunks_written=True)


def test_zstd_decompresses_as_zstandard():
    """Frames with and without their content size, at several levels,
    equal zstandard's input; a damaged frame or a wrong expected size
    raises."""
    rng = np.random.RandomState(2)
    data = rng.randint(0, 4, 300_000).astype(np.uint8).tobytes()
    for level in (1, 3, 19):
        for sized in (True, False):
            frame = zstandard.ZstdCompressor(
                level=level, write_content_size=sized).compress(data)
            assert bytes(zstd.decompress(frame)) == data
            assert bytes(zstd.decompress(frame, len(data))) == data
            with pytest.raises(ValueError):
                zstd.decompress(frame, len(data) - 1)
    with pytest.raises(ValueError):
        zstd.decompress(b"not a zstd frame")
    with pytest.raises(ValueError):
        zstd.decompress(frame[:-5])
    assert zstd.version().count(".") == 2


def test_zstd_without_the_library_raises_and_names_it(monkeypatch):
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(zstd, "SONAME", "libzstd.so.missing")
    zstd.library.cache_clear()
    try:
        with pytest.raises(OSError, match="libzstd.so.missing"):
            zstd.decompress(b"\x28\xb5\x2f\xfd")
    finally:
        monkeypatch.undo()
        zstd.library.cache_clear()
    assert zstd.version()

# ---------------------------------------------------------------- refusals


def _rewrite(path, key, value):
    """Put `value` at `key` in the checkpoint's root OCDBT store (a new
    version of the root manifest, written by tensorstore); None deletes
    the key."""
    ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}
                    ).result().write(key, value).result()


def _flip_byte(path):
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        data[len(data) // 2] ^= 0x40
        f.seek(0)
        f.write(data)


def _zarray(path, name):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    return json.loads(kv.read(name + "/.zarray").result().value)


KERNEL = "params.params.BEVHead_0.cls.kernel"


def _refusal_manifest(path):
    _flip_byte(os.path.join(path, "manifest.ocdbt"))
    return "crc32c mismatch"


def _refusal_zarr3(path):
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["use_zarr3"] = True
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return "zarr3"


def _refusal_compressor(path):
    meta = _zarray(path, KERNEL)
    meta["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5,
                          "shuffle": 1}
    _rewrite(path, KERNEL + "/.zarray", json.dumps(meta).encode())
    return "compressor 'blosc'"


def _refusal_missing_chunk(path):
    _rewrite(path, KERNEL + "/0.0.0.0", None)
    return "missing chunk"


def _refusal_missing_file(path):
    sub = os.path.join(path, "ocdbt.process_0", "d")
    os.remove(os.path.join(sub, max(os.listdir(sub), key=lambda n: (
        os.path.getsize(os.path.join(sub, n))))))
    return "missing data file"


def _refusal_second_process(path):
    shutil.copytree(os.path.join(path, "ocdbt.process_0"),
                    os.path.join(path, "ocdbt.process_1"))
    return "second process"


def _refusal_no_manifest(path):
    os.remove(os.path.join(path, "manifest.ocdbt"))
    return "is not an orbax checkpoint"


@pytest.mark.parametrize("damage", [
    _refusal_manifest, _refusal_zarr3, _refusal_compressor,
    _refusal_missing_chunk, _refusal_missing_file, _refusal_second_process,
    _refusal_no_manifest], ids=lambda f: f.__name__.removeprefix("_refusal_"))
def test_reader_refuses_by_name(tmp_path, damage):
    """What the reader does not know or cannot trust it refuses with a
    ValueError that names it, on a damaged copy of the committed fixture;
    the undamaged copy reads."""
    path = str(tmp_path / "epoch1")
    shutil.copytree(C.latest_epoch_dir(FIXTURE), path)
    R.read_orbax(path)
    match = damage(path)
    with pytest.raises(ValueError, match=match):
        R.read_orbax(path)


def test_bridges_take_the_readers_bfloat16_leaves():
    """A bfloat16 leaf, which the reader returns as a torch.bfloat16
    tensor, is bridged at its float32 value."""
    kernel = torch.randn(3, 3, 2, 4).to(torch.bfloat16)
    sd = dsgn_state_dict_from_flax({"conv": {"kernel": kernel,
                                             "bias": kernel[0, 0, 0]}})
    assert torch.equal(sd["conv.weight"], kernel.float().permute(3, 2, 0, 1))
    assert sd["conv.bias"].dtype == torch.float32

# ----------------------------------------------------- optimizer state


def _jax_chain_state(steps):
    """The JAX trainer's optax chain on test_torch_train's small state,
    after `steps` updates from seeded gradients; and those gradients."""
    from test_torch_train import _state
    state = jax.tree_util.tree_map(jnp.asarray, _state())
    tx = jax_train.make_detector_optimizer(
        optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 8))
    opt_state = tx.init(state)
    rng = np.random.RandomState(4)
    grads = [jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
        state) for _ in range(4)]
    for g in grads[:steps]:
        updates, opt_state = tx.update(g, opt_state, state)
        state = optax.apply_updates(state, updates)
    return tx, state, opt_state, grads


def test_optax_state_converts_exactly(tmp_path):
    """Two optax updates, saved by orbax, read and converted, then two
    more updates in each package from the same gradients: the same
    parameters (within 1e-6), `mean`/`var` frozen bit for bit, the same
    count."""
    tx, state, opt_state, grads = _jax_chain_state(2)
    save_checkpoint(str(tmp_path / "ck"), {"params": state,
                                           "opt_state": opt_state})
    tree = R.read_orbax(str(tmp_path / "ck"))

    def flat(t):
        return {".".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(t)}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in flat(tree["params"]).items()}
    named = [(k.removeprefix("params."), p) for k, p in params.items()]
    opt = T.make_detector_optimizer(named, T.warmup_cosine_decay(1e-2, 2, 8))

    def moments(t):
        out = {k.removeprefix("params."): torch.from_numpy(v.copy())
               for k, v in flat(t.get("params", {})).items()}
        if "uncert" in t:
            out["uncert"] = torch.as_tensor(t["uncert"])
        return out
    opt.load_state_dict(T.detector_state_from_optax(
        opt, named, tree["opt_state"], moments))
    assert opt.count == 2
    for g in grads[2:]:
        updates, opt_state = tx.update(g, opt_state, state)
        state = optax.apply_updates(state, updates)
        opt.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(flat(g)[k].copy())
        opt.step()
    for k, v in flat(state).items():
        np.testing.assert_allclose(params[k].detach().numpy(), v, rtol=0,
                                   atol=1e-6, err_msg=k)
        if k.endswith(("mean", "var")):
            assert np.array_equal(params[k].detach().numpy(),
                                  flat(tree["params"])[k]), k
    assert opt.count == 4


def test_optax_state_of_another_chain_is_refused():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = T.make_detector_optimizer([("w", p)],
                                    T.warmup_cosine_decay(1e-2, 2, 8))
    with pytest.raises(ValueError, match="not the optax state"):
        T.detector_state_from_optax(opt, [("w", p)], [None], lambda t: t)
    no_moments = [None] + [{"inner_state": [{"count": 1, "mu": {},
                                             "nu": {}}]}] * 2
    with pytest.raises(ValueError, match="no moments of w"):
        T.detector_state_from_optax(opt, [("w", p)], no_moments,
                                    lambda t: t)
