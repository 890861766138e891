"""Read the JAX package's orbax checkpoints without JAX, orbax, tensorstore
or zstandard.

The JAX trainers save each epoch with `ocp.PyTreeCheckpointer`
(eval_driving_safety_tpu/utils/checkpoint.py). The orbax they run with
(0.11) writes a directory that holds:
* `_METADATA`, JSON: `tree_metadata` maps each leaf to its keys (a dict
  key or a sequence index each) and its value type, beside `use_ocdbt`,
  `use_zarr3` and `store_array_data_equal_to_fill_value`;
* an OCDBT key-value store (tensorstore's B+tree database): the root
  `manifest.ocdbt`, whose B-tree nodes and out-of-line values lie in the
  `d/` files of the root and of the process's sub-database
  `ocdbt.process_0/`;
* in that store, one zarr v2 array per array leaf: `<keys joined by
  ".">/.zarray` (JSON) and its chunks `<keys>/<i>.<j>...` (`0` for a
  scalar), each chunk one zstd frame;
* `_strings.json` for string leaves.

`read_orbax(path)` returns the tree that orbax's `restore(path)` gives,
with numpy arrays for its arrays (bfloat16 ones as torch.bfloat16
tensors, their bits kept) and Python scalars for its scalars. What it
does not know it refuses with ValueError, naming it: a zarr3 or non-OCDBT
checkpoint, another compressor, a missing chunk or data file, a second
process's sub-database, a bad checksum.

The OCDBT files (integers little-endian, varint = LEB128):
  envelope   magic (u32, big-endian: 0x0cdb3a2a manifest, 0x0cdb20de
             B-tree node), u64 file length, varint format version (0),
             u8 compression (0 none, 1 zstd), the body, u32 crc32c of all
             bytes before it.
  manifest   config: 16-byte uuid, varint manifest kind (0 = one file),
             varint max inline value bytes, varint max decoded node bytes,
             u8 version tree arity log2, varint compression (1 = zstd,
             then an i32 level); a data file table; the newest versions,
             a count and the columns generation, u8 root height, the
             root's data file, offset and length, its key count, tree
             bytes and out-of-line value bytes, u64 commit time. Older
             versions' nodes follow; the newest version is the last one.
  node       u8 height, a data file table, a varint entry count, the keys:
             varint lengths each shares with the previous key (entries
             1..n-1), varint suffix lengths, the suffixes. A leaf (height
             0) goes on with varint value lengths, varint value kinds (0
             inline, 1 in a data file), the out-of-line values' data files
             and offsets, then the inline values back to back. An interior
             node goes on with the varint length of the prefix its child's
             keys leave out (before the suffixes), and after them the
             children's data files, offsets and lengths and three columns
             of statistics.
  file table varint count; varint lengths each path shares with the
             previous one (1..n-1); suffix lengths; base path lengths; the
             suffixes. A path is relative to the database's directory,
             behind the base path of the file that holds the table.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from eval_driving_safety_tpu_torch.utils import zstd
from eval_driving_safety_tpu_torch.utils.checkpoint import \
    is_orbax_checkpoint

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
METADATA = "_METADATA"
_KINDS = {1: "seq", 2: "dict"}                  # orbax's key types
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return tuple(table)


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT files."""
    c, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads a body field by field; running past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = bytes(self.data[self.pos: self.pos + n])
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = 0
        for shift in range(0, 70, 7):
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
        raise ValueError(f"{self.what}: varint longer than 10 bytes")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _open(raw: bytes, magic: int, what: str) -> _Cursor:
    """The body of one OCDBT file (a manifest or a B-tree node), its
    envelope checked and its compression undone."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "B-tree node"
        raise ValueError(f"{what}: not an OCDBT {kind}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: length field {length} != {len(raw)} "
                         "bytes")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{what}: crc32c mismatch")
    head = _Cursor(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    compression = head.u8()
    body = raw[12 + head.pos: -4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"{what}: compression format {compression}")
    return _Cursor(body, what)


def _keys(cur: _Cursor, n: int, column: bool = False):
    """n prefix-compressed byte strings (keys, or paths); with `column`,
    the n varints stored between their lengths and their bytes (an
    interior node's subtree prefix lengths, a file table's base path
    lengths)."""
    shared = [0] + cur.varints(n - 1) if n else []
    lengths = cur.varints(n)
    extra = cur.varints(n) if column else None
    keys, prev = [], b""
    for s, ln in zip(shared, lengths):
        if s > len(prev):
            raise ValueError(f"{cur.what}: a key shares {s} bytes of "
                             f"{len(prev)}")
        prev = prev[:s] + cur.take(ln)
        keys.append(prev)
    return keys, extra


def _file_table(cur: _Cursor, base: str) -> list:
    """A node's or manifest's data files as (path, base path), both
    relative to the database's directory: each stored path stands behind
    `base`, the base path of the file that holds the table."""
    paths, bases = _keys(cur, cur.varint(), column=True)
    return [(base + p.decode(), base + p[:b].decode())
            for p, b in zip(paths, bases)]


class _Store:
    """The key-value pairs of one OCDBT database directory, read through
    its manifest: `values[key]` is the value's bytes inline, or (path,
    offset, length) in a data file."""

    def __init__(self, root: str):
        self.root = root
        what = os.path.join(root, MANIFEST)
        with open(what, "rb") as f:
            cur = _open(f.read(), MANIFEST_MAGIC, what)
        cur.take(16)                              # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (numbered "
                             "manifests are not read)")
        cur.varints(2)                            # inline / node limits
        cur.u8()                                  # version tree arity
        if cur.varint() == 1:                     # zstd, and its level
            cur.take(4)
        files = _file_table(cur, "")
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{what}: no version")
        cols = [cur.varints(n)]                   # generation
        cols.append([cur.u8() for _ in range(n)])  # root height
        for _ in range(6):                        # file, offset, length,
            cols.append(cur.varints(n))           # keys, bytes, indirect
        _, height, fid, offset, length, num_keys = (c[-1] for c in cols[:6])
        self.values = {}
        if num_keys:
            self._walk(*files[fid], offset, length, height, b"")

    def _read(self, path: str, offset: int, length: int) -> bytes:
        full = os.path.join(self.root, path)
        if path.split("/")[0].startswith("ocdbt.process_") and \
                not path.startswith("ocdbt.process_0/"):
            raise ValueError(f"{full}: a second process's sub-database "
                             "(multi-process checkpoints are not read)")
        if not os.path.isfile(full):
            raise ValueError(f"missing data file {full}")
        with open(full, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{full}: {len(data)} bytes at {offset}, "
                             f"expected {length}")
        return data

    def _walk(self, path, base, offset, length, height, prefix):
        what = f"{os.path.join(self.root, path)}@{offset}"
        cur = _open(self._read(path, offset, length), NODE_MAGIC, what)
        if cur.u8() != height:
            raise ValueError(f"{what}: node height differs from its "
                             "reference")
        files = _file_table(cur, base)
        n = cur.varint()
        if height == 0:
            keys, _ = _keys(cur, n)
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if set(kinds) - {0, 1}:
                raise ValueError(f"{what}: value kinds {sorted(set(kinds))}")
            m = sum(kinds)
            fids, offsets = cur.varints(m), cur.varints(m)
            refs = iter(zip(fids, offsets))
            for key, ln, kind in zip(keys, lengths, kinds):
                if kind:
                    fid, off = next(refs)
                    self.values[prefix + key] = (files[fid][0], off, ln)
                else:
                    self.values[prefix + key] = cur.take(ln)
            return
        keys, common = _keys(cur, n, column=True)
        fids, offsets, lengths = (cur.varints(n) for _ in range(3))
        for key, c, fid, off, ln in zip(keys, common, fids, offsets,
                                        lengths):
            self._walk(*files[fid], off, ln, height - 1, prefix + key[:c])

    def get(self, key: str):
        """The value's bytes, or None where the key is absent."""
        v = self.values.get(key.encode())
        if isinstance(v, tuple):
            return self._read(*v)
        return v


def _dtype(name: str, what: str):
    """numpy dtype of a zarr v2 dtype string; bfloat16 as int16 bits."""
    if name == "bfloat16":
        return np.dtype(np.int16), True
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"{what}: dtype {name!r}") from None
    if dt.kind not in "biufc":
        raise ValueError(f"{what}: dtype {name!r}")
    return dt, False


def _fill(meta: dict, dt, bf16: bool):
    fv = meta.get("fill_value")
    if fv is None:
        return 0
    if bf16:
        return int(torch.tensor(float(fv)).to(torch.bfloat16)
                   .view(torch.int16))
    return np.array(float(fv) if dt.kind in "fc" else fv).astype(dt)


def _read_array(store: _Store, name: str, chunks_written: bool):
    """The zarr v2 array `name` of the store: numpy, or torch.bfloat16."""
    what = f"array {name!r}"
    raw = store.get(name + "/.zarray")
    if raw is None:
        raise ValueError(f"{what}: no .zarray in the checkpoint")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr format {meta.get('zarr_format')}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp.get('id')!r} (only "
                         "zstd is read)")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{what}: order {meta['order']!r}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{what}: dimension separator {sep!r}")
    dt, bf16 = _dtype(meta["dtype"], what)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{what}: chunks {chunks} for shape {shape}")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks)) * dt.itemsize
    out = None
    if grid != [1] * len(shape):
        out = np.empty(shape, dt)
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.get(key)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        if data is None:
            if chunks_written:
                raise ValueError(f"{what}: missing chunk {key!r}")
            if out is None:
                out = np.empty(shape, dt)
            out[sl] = _fill(meta, dt, bf16)
            continue
        data = zstd.decompress(data, nbytes) if comp else bytearray(data)
        if len(data) != nbytes:
            raise ValueError(f"{what}: chunk {key!r} holds {len(data)} "
                             f"bytes, expected {nbytes}")
        chunk = np.frombuffer(data, dt).reshape(chunks)
        if out is None:                           # the one chunk
            out = chunk if chunks == shape else chunk[sl].copy()
        else:
            out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:                               # an empty grid
        out = np.empty(shape, dt)
    if not dt.isnative:
        out = out.astype(dt.newbyteorder("="))
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def read_orbax(path: str) -> dict:
    """The tree of the orbax PyTree checkpoint directory `path`, as
    `ocp.PyTreeCheckpointer().restore(path)` gives it: dicts and lists as
    its keys say, numpy arrays (bfloat16 ones as torch.bfloat16 tensors),
    Python scalars, strings, and None for the empty states it stored."""
    if not is_orbax_checkpoint(path):
        raise ValueError(f"{path} is not an orbax checkpoint: it lacks "
                         f"{METADATA} or {MANIFEST}")
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or "tree_metadata" not in meta:
        raise ValueError(f"{path}: {METADATA} has no tree_metadata")
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: a zarr3 checkpoint (only zarr v2 is "
                         "read)")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: not an OCDBT checkpoint")
    others = sorted(n for n in os.listdir(path)
                    if re.fullmatch(r"ocdbt\.process_\d+", n)
                    and n != "ocdbt.process_0")
    if others:
        raise ValueError(f"{path}: a second process's sub-database "
                         f"({others[0]}; multi-process checkpoints are "
                         "not read)")
    store = _Store(path)
    written = bool(meta.get("store_array_data_equal_to_fill_value", False))
    strings = None
    root = _Node()
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        name = ".".join(str(k["key"]) for k in keys)
        if vtype in _EMPTY:
            value = _EMPTY[vtype]()
        elif vtype in ("jax.Array", "np.ndarray", "scalar"):
            value = _read_array(store, name, written)
            if vtype == "scalar":
                value = value.item()
        elif vtype == "string":
            if strings is None:
                with open(os.path.join(path, "_strings.json")) as f:
                    strings = json.load(f)
            value = strings[name]
        else:
            raise ValueError(f"{path}: leaf {name!r} of value type "
                             f"{vtype!r}")
        root.insert(keys, value, path)
    return root.tree()


class _Node(dict):
    """A container of the tree being built: a dict, or a sequence whose
    children are keyed by index."""
    kind = None

    def insert(self, keys: list, value, path: str) -> None:
        node = self
        for i, k in enumerate(keys):
            kind = _KINDS.get(k["key_type"])
            if kind is None:
                raise ValueError(f"{path}: key type {k['key_type']}")
            if node.kind not in (None, kind):
                raise ValueError(f"{path}: {k['key']!r} mixes dict keys "
                                 "and sequence indices")
            node.kind = kind
            key = int(k["key"]) if kind == "seq" else k["key"]
            if i == len(keys) - 1:
                if key in node:
                    raise ValueError(f"{path}: leaf {key!r} twice")
                node[key] = value
            else:
                node = node.setdefault(key, _Node())
                if not isinstance(node, _Node):
                    raise ValueError(f"{path}: {key!r} is a leaf and a "
                                     "container")

    def tree(self):
        """The built tree of dicts and lists."""
        done = {k: v.tree() if isinstance(v, _Node) else v
                for k, v in self.items()}
        if self.kind != "seq":
            return done
        if sorted(done) != list(range(len(done))):
            raise ValueError(f"sequence indices {sorted(done)}")
        return [done[i] for i in range(len(done))]
