"""Helpers of the train-state checkpoint tests
(tests/test_torch_train_state_orbax*.py): trees of either package
flattened to {dotted path: array}, compared bit for bit, an orbax
node's `_METADATA` with each array's shape and dtype, and run
directories copied without copying their nodes' arrays."""
import json
import os
import shutil

import jax
import numpy as np

from cvpce_tpu_torch.utils.ocdbt import OcdbtStore
from cvpce_tpu_torch.utils.orbax_read import METADATA


def flat_jax(state) -> dict:
    """A JAX pytree (a flax struct, optax's namedtuples, dicts, tuples)
    as {dotted path: numpy array}; its empty nodes hold no leaf."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        keys = []
        for k in path:
            for attr in ("name", "key", "idx"):
                if hasattr(k, attr):
                    keys.append(str(getattr(k, attr)))
                    break
        out[".".join(keys)] = np.asarray(leaf)
    return out


def flat_tree(tree, trail=()) -> dict:
    """A port tree (dicts, lists, None for an empty node) likewise."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {".".join(trail): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, trail + (k,)))
    return out


def assert_bit_equal(got: dict, want: dict) -> None:
    """Same paths, and each leaf the same dtype, shape and bytes."""
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:8]
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                            w.dtype)
        assert g.tobytes() == w.tobytes(), k


def node_signature(directory: str) -> dict:
    """{leaf key: (key types, value_type, skip_deserialize, shape, dtype)}
    of an orbax node: its `_METADATA` and each array's `.zarray`."""
    with open(os.path.join(directory, METADATA)) as f:
        meta = json.load(f)
    store = OcdbtStore(directory)
    out = {}
    for key, entry in meta["tree_metadata"].items():
        keys = [k["key"] for k in entry["key_metadata"]]
        vm = entry["value_metadata"]
        shape = dtype = None
        if not vm["skip_deserialize"]:
            z = json.loads(store.read(".".join(keys) + "/.zarray"))
            shape, dtype = tuple(z["shape"]), z["dtype"]
        out[key] = (tuple(k["key_type"] for k in entry["key_metadata"]),
                    vm["value_type"], vm["skip_deserialize"], shape, dtype)
    return out


def copy_run(src, dst) -> None:
    """A run directory copied with its large files (the nodes' arrays,
    0.26 GB a GLN node) hard-linked: a save writes them anew and never
    in place. Small files, which the loops rewrite in place (the meta
    sidecars), are copied."""
    def link_or_copy(a, b):
        if os.path.getsize(a) > 1 << 20:
            os.link(a, b)
        else:
            shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=link_or_copy)
