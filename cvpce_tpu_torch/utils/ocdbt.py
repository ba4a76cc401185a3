"""Reader of tensorstore's OCDBT key-value store, as orbax writes it.

The JAX package's checkpoints (`ocp.StandardCheckpointer`, with
`use_ocdbt`) keep every array as zarr keys inside one OCDBT store: a
copy-on-write b+tree whose nodes and values live in data files under
`d/`. The card's machine has no tensorstore, so the port reads the
format itself, decoding with its own zstd decoder (utils/zstd.py):

- `manifest.ocdbt`: magic 0x0cdb3a2a, its length, a format version and a
  compression byte, then (zstd-compressed where that byte is 1) the
  config (uuid, manifest kind, inline-value limit, node-size limit,
  version-tree arity, compression), the data-file table and the inline
  leaf of the version tree; a CRC-32C of everything before it ends the
  file. The newest version names the b+tree's root node.
- b+tree nodes: magic 0x0cdb20de with the same framing around the
  node's height, its data-file table and its entries; leaf entries hold
  each key with its value inline or as (data file, offset, length);
  interior entries hold each child's first key, the prefix its subtree
  shares and the child's location.
- data-file tables: paths written with the prefix they share with the
  one before, each split into a base path and a relative path. A node's
  paths are relative to the base path of the file the node sits in, so
  the root store orbax writes over its per-process stores
  (`ocdbt.process_0/`) reaches their files through it.

Only the newest version is read. Numbered manifests (the
`manifest_kind` 1 that tensorstore writes when several writers share a
store) raise NotImplementedError; corrupt or truncated files raise
OSError.

`write_store` is the inverse: it writes keys and values as a new store
of one version, in the config that orbax writes (`ORBAX_CONFIG`, as
`OcdbtStore.config` reads it from an export): values longer than the
inline limit go into one data file under `d/`, the b+tree after them
as one leaf node of every key (a serving export's ~650 keys take a few
tens of KB of the node's 100 MB limit; a store whose node would pass it
raises), the manifest and the node framed as above around a zstd frame
of Raw blocks (utils/zstd.py:compress). tensorstore's `ocdbt` kvstore
reads it.
"""
from __future__ import annotations

import os
import struct
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple

from . import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_FORMAT_VERSION = 0
_ZSTD = 1
_MISSING = (1 << 64) - 1
# what orbax's StandardCheckpointer writes (its tensorstore spec), as
# OcdbtStore(...).config reads it from artifacts/*/serving_checkpoint
ORBAX_CONFIG = {"manifest_kind": 0, "max_inline_value_bytes": 1024,
                "max_decoded_node_bytes": 100_000_000,
                "version_tree_arity_log2": 4, "compression": _ZSTD,
                "zstd_level": 0}


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    table = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Varints, bytes and little-endian integers out of a decoded body."""

    def __init__(self, data: bytes, name: str):
        self.data = data
        self.at = 0
        self.name = name

    def fail(self, what: str):
        raise OSError(f"{self.name}: {what}")

    def byte(self) -> int:
        if self.at >= len(self.data):
            self.fail("truncated")
        v = self.data[self.at]
        self.at += 1
        return v

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            self.fail("truncated")
        v = self.data[self.at:self.at + n]
        self.at += n
        return v

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def end(self) -> None:
        if self.at != len(self.data):
            self.fail(f"{len(self.data) - self.at} bytes left over")


def _unframe(encoded: bytes, magic: int, name: str) -> bytes:
    """The body of a manifest or node: checks the magic, the length, the
    version and the CRC-32C, and decodes the zstd body."""
    if len(encoded) < 4 + 8 + 2 + 4:
        raise OSError(f"{name}: truncated ({len(encoded)} bytes)")
    got_magic, length = struct.unpack(">I", encoded[:4])[0], \
        struct.unpack("<Q", encoded[4:12])[0]
    if got_magic != magic:
        raise OSError(f"{name}: magic {got_magic:08x}, {magic:08x} expected")
    if length != len(encoded):
        raise OSError(f"{name}: {len(encoded)} bytes, its header says "
                      f"{length}")
    want = struct.unpack("<I", encoded[-4:])[0]
    if crc32c(encoded[:-4]) != want:
        raise OSError(f"{name}: CRC-32C mismatch")
    head = _Reader(encoded[:-4], name)
    head.at = 12
    version = head.varint()
    if version != _FORMAT_VERSION:
        raise NotImplementedError(f"{name}: OCDBT format version {version}")
    compression = head.varint()
    body = encoded[head.at:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, name=name)
    raise NotImplementedError(f"{name}: OCDBT compression {compression}")


def _data_file_table(r: _Reader, transitive: str
                     ) -> Tuple[List[str], List[str]]:
    """The table's paths and their base paths, each with the reading
    node's own base path before it (so relative to the store's
    directory): a node's paths are relative to the base path of the
    file that holds it."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, bases, previous = [], [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            r.fail("data-file path prefix longer than the path before it")
        full = previous[:prefix[i]] + r.raw(suffix[i])
        if base[i] > len(full):
            r.fail("data-file base path longer than its path")
        paths.append(transitive + full.decode())
        bases.append(transitive + full[:base[i]].decode())
        previous = full
    return paths, bases


class _Location:
    __slots__ = ("path", "base", "offset", "length")

    def __init__(self, path: str, base: str, offset: int, length: int):
        self.path, self.base = path, base
        self.offset, self.length = offset, length


class OcdbtStore:
    """The newest version of the OCDBT store in `directory`: `keys()`
    in order, `read(key)` its bytes."""

    def __init__(self, directory: str):
        self.directory = directory
        name = os.path.join(directory, MANIFEST)
        if not os.path.exists(name):
            raise ValueError(f"{directory} holds no {MANIFEST}: not an "
                             "OCDBT store")
        r = _Reader(_unframe(self._file(MANIFEST), MANIFEST_MAGIC, name),
                    name)
        r.raw(16)                               # uuid
        kind = r.varint()
        self.config = {"manifest_kind": kind,
                       "max_inline_value_bytes": r.varint(),
                       "max_decoded_node_bytes": r.varint(),
                       "version_tree_arity_log2": r.byte(),
                       "compression": r.varint()}
        if self.config["compression"] == _ZSTD:
            self.config["zstd_level"] = r.u32()
        self.max_decoded_node_bytes = self.config["max_decoded_node_bytes"]
        if kind != 0:
            raise NotImplementedError(
                f"{name}: numbered manifests (manifest kind {kind})")
        files, bases = _data_file_table(r, "")
        n = r.varint()                          # inline versions
        r.varints(n)                            # generation numbers
        heights = [r.byte() for _ in range(n)]
        ids = r.varints(n)
        offsets = r.varints(n)
        lengths = r.varints(n)
        num_keys = r.varints(n)
        r.varints(n)                            # tree bytes
        r.varints(n)                            # indirect value bytes
        for _ in range(n):
            r.u64()                             # commit times
        # the version-tree nodes that follow reach older versions only
        self._entries: Dict[bytes, object] = {}
        if n == 0 or num_keys[-1] == 0:
            self._keys: List[bytes] = []
            return
        if ids[-1] >= len(files):
            r.fail("root node's data file is not in the table")
        self._walk(_Location(files[ids[-1]], bases[ids[-1]], offsets[-1],
                             lengths[-1]), heights[-1], b"")
        self._keys = sorted(self._entries)

    def _file(self, rel: str, offset: int = 0,
              length: Optional[int] = None) -> bytes:
        name = os.path.join(self.directory, rel)
        with open(name, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise OSError(f"{name}: {len(data)} bytes at {offset}, "
                          f"{length} expected")
        return data

    def _walk(self, loc: _Location, height: int, prefix: bytes) -> None:
        name = f"{os.path.join(self.directory, loc.path)}@{loc.offset}"
        body = _unframe(self._file(loc.path, loc.offset, loc.length),
                        NODE_MAGIC, name)
        if len(body) > self.max_decoded_node_bytes:
            raise OSError(f"{name}: node larger than the manifest allows")
        r = _Reader(body, name)
        if r.byte() != height:
            r.fail(f"node height differs from its parent's {height}")
        files, bases = _data_file_table(r, loc.base)
        n = r.varint()
        prefix_len = [0] + r.varints(n - 1) if n else []
        suffix_len = r.varints(n)
        subtree = r.varints(n) if height > 0 else []
        keys, previous = [], b""
        for i in range(n):
            if prefix_len[i] > len(previous):
                r.fail("key prefix longer than the key before it")
            key = previous[:prefix_len[i]] + r.raw(suffix_len[i])
            keys.append(key)
            previous = key
        if height > 0:
            ids = r.varints(n)
            offsets = r.varints(n)
            lengths = r.varints(n)
            for _ in range(3):                  # subtree statistics
                r.varints(n)
            r.end()
            for i in range(n):
                if ids[i] >= len(files):
                    r.fail("child's data file is not in the table")
                if subtree[i] > len(keys[i]):
                    r.fail("subtree prefix longer than its key")
                self._walk(_Location(files[ids[i]], bases[ids[i]],
                                     offsets[i], lengths[i]), height - 1,
                           prefix + keys[i][:subtree[i]])
            return
        sizes = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            r.fail("value kind other than inline (0) or indirect (1)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = r.varints(len(indirect))
        offsets = r.varints(len(indirect))
        for i, fid, off in zip(indirect, ids, offsets):
            if fid >= len(files):
                r.fail("value's data file is not in the table")
            self._entries[prefix + keys[i]] = _Location(
                files[fid], bases[fid], off, sizes[i])
        for i in range(n):
            if kinds[i] == 0:
                self._entries[prefix + keys[i]] = r.raw(sizes[i])
        r.end()

    def keys(self) -> List[bytes]:
        return list(self._keys)

    def __contains__(self, key) -> bool:
        return _key(key) in self._entries

    def read(self, key) -> bytes:
        entry = self._entries.get(_key(key))
        if entry is None:
            raise KeyError(key)
        if isinstance(entry, bytes):
            return entry
        return self._file(entry.path, entry.offset, entry.length)


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _frame(body: bytes, magic: int) -> bytes:
    """`_unframe`'s inverse: magic, length, format version, zstd, the
    body as a zstd frame, CRC-32C."""
    head = _varint(_FORMAT_VERSION) + _varint(_ZSTD)
    packed = zstd.compress(body)
    length = 4 + 8 + len(head) + len(packed) + 4
    encoded = (struct.pack(">I", magic) + struct.pack("<Q", length) + head
               + packed)
    return encoded + struct.pack("<I", crc32c(encoded))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _file_table(paths: List[str]) -> bytes:
    """A data-file table of paths relative to the store (base path
    empty), each prefix-coded against the one before."""
    raw = [p.encode() for p in paths]
    prefix = [_common(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    return (_varint(len(raw)) + _varints(prefix)
            + _varints(len(r) - p for r, p in zip(raw, [0] + prefix))
            + _varints(0 for _ in raw)
            + b"".join(r[p:] for r, p in zip(raw, [0] + prefix)))


def _keys(keys: List[bytes]) -> Tuple[bytes, bytes, bytes]:
    """(prefix lengths, suffix lengths, suffix bytes) of sorted keys."""
    prefix = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    starts = [0] + prefix
    return (_varints(prefix),
            _varints(len(k) - p for k, p in zip(keys, starts)),
            b"".join(k[p:] for k, p in zip(keys, starts)))


def _leaf_body(entries, file_table: bytes) -> bytes:
    """A height-0 node of (key, inline bytes or (offset, length))."""
    keys = [k for k, _ in entries]
    prefix, suffix, key_bytes = _keys(keys)
    inline = [v for _, v in entries if isinstance(v, bytes)]
    indirect = [v for _, v in entries if not isinstance(v, bytes)]
    return (b"\x00" + (file_table if indirect else _varint(0))
            + _varint(len(entries)) + prefix + suffix + key_bytes
            + _varints(len(v) if isinstance(v, bytes) else v[1]
                       for _, v in entries)
            + _varints(0 if isinstance(v, bytes) else 1 for _, v in entries)
            + _varints(0 for _ in indirect)
            + _varints(off for off, _ in indirect) + b"".join(inline))


def write_store(directory: str,
                items: Iterable[Tuple[bytes, bytes]]) -> Dict[str, int]:
    """Write `items` (distinct keys, str or bytes, with their bytes) as
    a new OCDBT store in `directory` (created; an existing store there
    raises). Returns the version's statistics: keys, nodes, tree bytes
    and indirect value bytes."""
    if os.path.exists(os.path.join(directory, MANIFEST)):
        raise ValueError(f"{directory} already holds an OCDBT store")
    entries = sorted((_key(k), bytes(v)) for k, v in items)
    for a, b in zip(entries, entries[1:]):
        if a[0] == b[0]:
            raise ValueError(f"OCDBT key {a[0]!r} given twice")
    stats = {"keys": len(entries), "nodes": 0, "tree_bytes": 0,
             "indirect_value_bytes": 0}
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    if entries:
        table, root = _write_tree(directory, entries, stats)
    else:
        # an empty tree: its root is missing, in a file of no name, as
        # tensorstore writes it
        table, root = _file_table([""]), (_MISSING, _MISSING, 0, 0, 0)
    cfg = ORBAX_CONFIG
    body = (uuid.uuid4().bytes + _varint(cfg["manifest_kind"])
            + _varint(cfg["max_inline_value_bytes"])
            + _varint(cfg["max_decoded_node_bytes"])
            + bytes([cfg["version_tree_arity_log2"]])
            + _varint(cfg["compression"]) + struct.pack("<I",
                                                        cfg["zstd_level"])
            + table + _varint(1) + _varint(1) + b"\x00"
            + _varints((0,) + root)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(directory, MANIFEST), "wb") as f:
        f.write(_frame(body, MANIFEST_MAGIC))
    return stats


def _write_tree(directory: str, entries, stats: Dict[str, int]):
    """Write the values over the inline limit, then the b+tree's one
    leaf node, into one data file; (the file table, the root's offset,
    length, keys, tree bytes and indirect bytes)."""
    data_name = "d/" + uuid.uuid4().hex
    table = _file_table([data_name])
    leaf, at = [], 0
    with open(os.path.join(directory, data_name), "wb") as f:
        for key, value in entries:
            if len(value) > ORBAX_CONFIG["max_inline_value_bytes"]:
                f.write(value)
                leaf.append((key, (at, len(value))))
                at += len(value)
                stats["indirect_value_bytes"] += len(value)
            else:
                leaf.append((key, value))
        body = _leaf_body(leaf, table)
        if len(body) > ORBAX_CONFIG["max_decoded_node_bytes"]:
            raise ValueError(
                f"{len(entries)} OCDBT keys take a leaf node of {len(body)} "
                f"bytes, over the limit of "
                f"{ORBAX_CONFIG['max_decoded_node_bytes']}")
        encoded = _frame(body, NODE_MAGIC)
        f.write(encoded)
    stats["nodes"] = 1
    stats["tree_bytes"] = len(encoded)
    return table, (at, len(encoded), len(entries), len(encoded),
                   stats["indirect_value_bytes"])
