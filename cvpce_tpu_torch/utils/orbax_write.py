"""Write orbax checkpoints without orbax, as the JAX package writes them.

`save(directory, tree)` writes what `ocp.StandardCheckpointer().save`
writes for a tree of numpy arrays (the JAX package's serving exports,
cvpce_tpu/pipeline/serving.py `_save`), so that orbax's restore, the
JAX serving loaders and the port's reader (utils/orbax_read.py) take it:

- `_METADATA`: the `tree_metadata` of every leaf, keyed by the tuple of
  its keys, with its `key_metadata` (dict keys key_type 2, sequence
  indices key_type 1) and `value_metadata`, in the order of JAX's tree
  flattening (dict keys sorted); then `use_ocdbt`, `use_zarr3` and the
  rest of orbax's fields;
- the arrays as zarr v2 in one OCDBT store at the directory's root
  (utils/ocdbt.py:write_store): `<dotted.path>/.zarray` and one chunk of
  the whole array, `0.0...` (`0` for shape ()), compressed with zstd
  (utils/zstd.py:compress, level 1 in the `.zarray` as orbax writes);
- `_CHECKPOINT_METADATA`, the StandardCheckpointHandler's.

Orbax also writes a per-process store under `ocdbt.process_0/` and
merges it into the root; the root store alone is what a restore reads.

Leaves: numpy arrays and numpy scalars of the dtypes the reader takes
(bool, int, uint and float, little-endian or of one byte, and ml_dtypes'
bfloat16, as JAX hands it over), in dicts with str keys and in lists.
Any other leaf or dtype, and an array of size 0 (which orbax refuses
too), raises ValueError naming the leaf; nothing falls back to another
format. The directory is written beside its target and moved into
place; an existing checkpoint there (or the single `torch.save` file an
earlier port export held) is renamed aside first and removed last, as
the JAX package's `_save` replaces it. Any other directory at the
target raises.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from . import ocdbt, zstd
from .orbax_read import METADATA

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
_SEQUENCE, _DICT = 1, 2
_ZSTD_META = {"id": "zstd", "level": 1}


def _flatten(tree, keys=()) -> Iterator[Tuple[tuple, Any]]:
    """((key, key_type), ...), leaf) in JAX's flattening order."""
    if isinstance(tree, dict) and tree:
        for k in tree:
            if not isinstance(k, str):
                raise ValueError(f"{_name(keys)}: dict key {k!r} is not a "
                                 "str")
        for k in sorted(tree):
            yield from _flatten(tree[k], keys + ((k, _DICT),))
    elif isinstance(tree, list) and tree:
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), _SEQUENCE),))
    else:
        yield keys, tree


def _name(keys) -> str:
    return ".".join(k for k, _ in keys) or "<root>"


def _array(name: str, leaf) -> Tuple[np.ndarray, str]:
    """(array, zarr dtype) of a numpy leaf, in the dtypes that
    orbax_read takes."""
    if not isinstance(leaf, (np.ndarray, np.generic)):
        raise ValueError(f"{name}: a {type(leaf).__name__} leaf is not "
                         "written (numpy arrays and scalars only)")
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as JAX hands it over
        return arr.view(np.uint16), "bfloat16"
    if (arr.dtype.fields is not None or arr.dtype.kind not in "biuf"
            or arr.dtype.byteorder == ">"):
        raise ValueError(f"{name}: dtype {arr.dtype.str} is not written "
                         "(little-endian bool, int, uint, float or "
                         "bfloat16 only)")
    if arr.size == 0:
        raise ValueError(f"{name}: an array of size 0 {arr.shape} (orbax "
                         "refuses them too)")
    return arr, arr.dtype.str


def _zarr(name: str, arr: np.ndarray, dtype: str) -> List[Tuple[str, bytes]]:
    """The store's items of one array: `.zarray` and its one chunk."""
    meta = {"chunks": list(arr.shape), "compressor": _ZSTD_META,
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape),
            "zarr_format": 2}
    chunk = ".".join("0" for _ in arr.shape) or "0"
    return [(f"{name}/.zarray",
             json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()),
            (f"{name}/{chunk}", zstd.compress(arr.tobytes(order="C")))]


def _replace(directory: str, tmp: str) -> None:
    """Move `tmp` to `directory`, the old checkpoint there renamed aside
    first and removed once the new one is in place."""
    old = None
    if os.path.lexists(directory):
        if os.path.isdir(directory) and not any(
                os.path.exists(os.path.join(directory, n))
                for n in (CHECKPOINT_METADATA, ocdbt.MANIFEST)):
            raise ValueError(f"{directory} holds no orbax checkpoint; not "
                             "replaced")
        old = f"{directory}.old-{os.getpid()}"
        os.rename(directory, old)
    os.rename(tmp, directory)
    if old is None:
        return
    if os.path.isdir(old) and not os.path.islink(old):
        shutil.rmtree(old)
    else:  # a torch.save export of the port's
        os.remove(old)


def save(directory: str, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Write `tree` as an orbax checkpoint in `directory`. Returns the
    OCDBT store's statistics (utils/ocdbt.py:write_store) with the
    arrays' raw bytes under `array_bytes`."""
    if not isinstance(tree, dict):
        raise ValueError(f"an orbax checkpoint holds a dict, not a "
                         f"{type(tree).__name__}")
    started = time.time_ns()
    tree_metadata, items, array_bytes = {}, [], 0
    for keys, leaf in _flatten(tree):
        name = _name(keys)
        arr, zdtype = _array(name, leaf)
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
        items += _zarr(name, arr, zdtype)
        array_bytes += arr.nbytes
    directory = os.path.abspath(directory)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(directory)
                           + ".orbax-checkpoint-tmp-",
                           dir=os.path.dirname(directory))
    try:
        stats = ocdbt.write_store(tmp, items)
        metadata = {"tree_metadata": tree_metadata, "use_ocdbt": True,
                    "use_zarr3": False,
                    "store_array_data_equal_to_fill_value": True,
                    "custom_metadata": None}
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump(metadata, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": started,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        _replace(directory, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dict(stats, array_bytes=array_bytes)
