"""Read the JAX package's orbax checkpoints without orbax.

`restore(directory)` returns what `ocp.StandardCheckpointer().restore`
returns for a checkpoint that the JAX package wrote (its serving
exports, cvpce_tpu/pipeline/serving.py `_save`, and its training runs'
`checkpoint`, `epoch_N`, `embedder_checkpoint` and `gan_checkpoint`
nodes, cvpce_tpu/train/checkpoint.py): a nested dict of numpy arrays,
leaf for leaf and bit for bit.

- The tree comes from `_METADATA`: each leaf's `key_metadata` lists its
  keys, a dict key (key_type 2) or a sequence index (key_type 1, which
  comes back as a list, as orbax returns tuples and lists). The zarr
  array of a leaf is named by its keys joined with dots; the names are
  never split, since a key may hold a dot.
- Arrays are zarr v2 inside the OCDBT store (utils/ocdbt.py): `.zarray`
  JSON, then chunks compressed with zstd (utils/zstd.py) in C order,
  named by their grid index joined with dots. A grid of several chunks
  is reassembled; a missing chunk takes the fill_value (zero where it
  is null, as tensorstore fills).
- Dtypes: little-endian numpy types (`<f4`, `<f8`, `<i4`, `<i8`, `|i1`,
  `|u1`, `|b1`, ...) as numpy arrays, `bfloat16` as a torch.bfloat16
  tensor (numpy has no bfloat16). Arrays of shape () come back as 0-d
  arrays, Python scalars saved as such (value_type "scalar") as int or
  float, and the empty nodes orbax keeps as None, {}, [] or ().

Anything else (zarr v3, a compressor other than zstd, a filter, Fortran
order, another dimension separator, a fill_value that is not a number,
a big-endian or structured dtype, a non-OCDBT checkpoint) raises
NotImplementedError naming the array and the feature; corrupt data
raises OSError.
"""
from __future__ import annotations

import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import zstd
from .ocdbt import OcdbtStore

METADATA = "_METADATA"
_SEQUENCE, _DICT = 1, 2
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": tuple}
# leaves decoded at once (the zstd decoder releases the GIL)
_THREADS = 8


def is_checkpoint(directory: str) -> bool:
    """Whether `directory` holds an orbax checkpoint (its `_METADATA`)."""
    return os.path.isfile(os.path.join(directory, METADATA))


def _dtype(name: str, text: str):
    """(numpy storage dtype, whether it is bfloat16)."""
    if text == "bfloat16":
        return np.dtype(np.uint16), True
    if not isinstance(text, str) or text[:1] not in ("<", "|"):
        raise NotImplementedError(f"{name}: zarr dtype {text!r}")
    try:
        dt = np.dtype(text)
    except TypeError:
        raise NotImplementedError(f"{name}: zarr dtype {text!r}") from None
    if dt.fields is not None or dt.kind not in "biuf":
        raise NotImplementedError(f"{name}: zarr dtype {text!r}")
    return dt, False


def _fill(meta: Dict, name: str):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        raise NotImplementedError(f"{name}: zarr fill_value {value!r}")
    return value


def _read_array(store: OcdbtStore, name: str):
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        if f"{name}/zarr.json" in store:
            raise NotImplementedError(f"{name}: zarr v3 arrays") from None
        raise OSError(f"{store.directory}: no array {name}") from None
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(
            f"{name}: zarr format {meta.get('zarr_format')}")
    compressor = meta.get("compressor")
    if not compressor or compressor.get("id") != "zstd":
        raise NotImplementedError(f"{name}: zarr compressor {compressor}")
    if meta.get("filters"):
        raise NotImplementedError(f"{name}: zarr filters {meta['filters']}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{name}: zarr order {meta['order']}")
    if meta.get("dimension_separator", ".") != ".":
        raise NotImplementedError(
            f"{name}: zarr dimension separator "
            f"{meta['dimension_separator']!r}")
    dt, bf16 = _dtype(name, meta.get("dtype"))
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OSError(f"{name}: chunks {chunks} do not fit shape {shape}")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, dt)
    if out.size:
        whole = all(g == 1 for g in grid) and chunks == shape
        for index in itertools.product(*(range(g) for g in grid)):
            key = f"{name}/{'.'.join(map(str, index)) or '0'}"
            if key not in store:
                region = tuple(slice(i * c, (i + 1) * c)
                               for i, c in zip(index, chunks))
                out[region] = _fill(meta, name)
                continue
            data = store.read(key)
            if whole:
                zstd.decompress_into(data, out.reshape(-1).view(np.uint8),
                                     key)
                continue
            chunk = np.empty(chunks, dt)
            zstd.decompress_into(data, chunk.reshape(-1).view(np.uint8), key)
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(index, chunks, shape))
            out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _leaves(directory: str) -> List[Tuple[List[Tuple[Any, int]], Dict]]:
    with open(os.path.join(directory, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{directory}: zarr v3 checkpoints")
    if not meta.get("use_ocdbt", False):
        raise NotImplementedError(f"{directory}: checkpoints without OCDBT")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
        leaves.append((keys, entry["value_metadata"]))
    return leaves


def _build(leaves: List[Tuple[List[Tuple[Any, int]], Any]]):
    """The nested dict (lists where the keys are sequence indices)."""
    root: Dict = {}
    kinds: Dict[int, int] = {}
    for keys, value in leaves:
        node = root
        for depth, (key, kind) in enumerate(keys):
            if kind not in (_SEQUENCE, _DICT):
                raise NotImplementedError(
                    f"{'.'.join(str(k) for k, _ in keys)}: orbax key type "
                    f"{kind}")
            kinds.setdefault(id(node), kind)
            if kinds[id(node)] != kind:
                raise OSError("orbax tree mixes dict keys and sequence "
                              "indices in one node")
            name = int(key) if kind == _SEQUENCE else str(key)
            if depth == len(keys) - 1:
                node[name] = value
            else:
                node = node.setdefault(name, {})

    def finish(node):
        if not isinstance(node, dict) or not node and id(node) not in kinds:
            return node
        if kinds.get(id(node)) == _SEQUENCE:
            if sorted(node) != list(range(len(node))):
                raise OSError(f"orbax sequence indices {sorted(node)}")
            return [finish(node[i]) for i in range(len(node))]
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def restore(directory: str) -> Dict[str, Any]:
    """The tree of the orbax checkpoint in `directory`, as
    `ocp.StandardCheckpointer().restore(directory)` gives it."""
    if not is_checkpoint(directory):
        raise ValueError(f"{directory} holds no {METADATA}: not an orbax "
                         "checkpoint")
    leaves = _leaves(directory)
    store = OcdbtStore(directory)

    def value(leaf):
        keys, vmeta = leaf
        vtype = vmeta.get("value_type")
        name = ".".join(str(k) for k, _ in keys)
        if vtype in _EMPTY:
            empty = _EMPTY[vtype]
            return empty() if callable(empty) else empty
        if vtype not in ("np.ndarray", "jax.Array", "scalar"):
            raise NotImplementedError(f"{name}: orbax value type {vtype!r}")
        array = _read_array(store, name)
        if vtype == "scalar":
            return array.item()
        return array

    with ThreadPoolExecutor(_THREADS) as pool:
        values = list(pool.map(value, leaves))
    return _build([(keys, v) for (keys, _), v in zip(leaves, values)])
