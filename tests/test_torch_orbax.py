"""The port's reader of the JAX package's orbax checkpoints
(cvpce_tpu_torch/utils/ocdbt.py, utils/orbax_read.py) and the loaders on
it (pipeline/serving.py, cli/common.py, cli/dihe.py `load_gan_state`):

- the OCDBT store gives tensorstore's key list and bytes exactly, on the
  trained exports, the committed fixture and stores that tensorstore
  writes with interior nodes, without compression and over several
  versions; numbered manifests raise NotImplementedError, corrupt files
  OSError;
- `restore` equals `ocp.StandardCheckpointer().restore` leaf for leaf,
  bit for bit (dtype and shape too) on artifacts/gln_r5 and
  artifacts/dihe_r4, on the committed fixture (also against the seeded
  tree it was written from), and on a JAX GLN run node, a JAX DIHE run
  and a JAX GAN pretraining run written here by
  cvpce_tpu/train/checkpoint.py; zarr chunk grids, missing chunks and
  the dtypes against tensorstore's zarr driver; the other six exports
  match tests/torch_fixtures/orbax_digests.json, whose gln_r5 and
  dihe_r4 entries are held to orbax;
- the loaders return the state_dicts of the JAX loaders through the
  bridges (utils/weights.py), bit for bit, and keep JAX's refusals.

Everything is compared exactly."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

from torch_eval_common import DIHE_DIR, GLN_DIR, REPO, export_dir
from torch_eval_common import jax_restore, port_restore

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.utils import ocdbt, orbax_read

OTHER_EXPORTS = ("gln_r3", "gln_r4ft", "dihe_r3", "dihe_r3_triplet",
                 "dihe_r4_triplet", "dihe_r4aug")
FIXTURE = os.path.join(REPO, testing.ORBAX_FIXTURE_DIR)


def assert_same_tree(got, want, trail=""):
    """`got` (the port's restore) equals `want` (orbax's) leaf for leaf:
    the same structure, dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), trail
        for k in want:
            assert_same_tree(got[k], want[k], f"{trail}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), trail
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{trail}/{i}")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, trail
    else:
        w = np.asarray(want)
        if isinstance(got, torch.Tensor):  # bfloat16
            assert got.dtype == torch.bfloat16 and w.dtype.name == \
                "bfloat16", trail
            assert got.view(torch.int16).numpy().tobytes() == \
                w.tobytes(), trail
            return
        assert isinstance(got, np.ndarray), (trail, type(got))
        assert (got.dtype, got.shape) == (w.dtype, w.shape), trail
        assert got.tobytes() == w.tobytes(), trail


def _state(a, b):
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _jax_restore_dir(d):
    from cvpce_tpu.pipeline.serving import _raw_restore

    return jax.device_get(_raw_restore(os.path.abspath(d)))


# ---------------------------------------------------------------- OCDBT

def _tensorstore(directory):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{directory}"}).result()


@pytest.mark.parametrize("where", ["gln_r5", "dihe_r4", "fixture",
                                   "gln_r5_process_0"])
def test_ocdbt_matches_tensorstore(where):
    """Every key, in order, and its bytes; the root stores reach the
    values of `ocdbt.process_0/` through their data-file tables."""
    d = {"fixture": FIXTURE,
         "gln_r5_process_0": os.path.join(export_dir("gln_r5"),
                                          "ocdbt.process_0")}.get(
        where) or export_dir(where)
    store = ocdbt.OcdbtStore(d)
    kv = _tensorstore(d)
    keys = kv.list().result()
    assert store.keys() == list(keys)
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key


@pytest.mark.parametrize("layout", ["small_nodes", "uncompressed",
                                    "versions"])
def test_ocdbt_layouts_tensorstore_writes(layout, tmp_path):
    """Interior nodes (1 KB nodes: a tree of height 3, subtree prefixes),
    nodes without compression, and a store rewritten over several
    commits with deletions: the newest version, key for key."""
    config = {"small_nodes": {"max_decoded_node_bytes": 1024,
                              "max_inline_value_bytes": 64},
              "uncompressed": {"compression": None},
              "versions": {}}[layout]
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": config}).result()
    rng = np.random.default_rng(len(layout))
    want = {}
    for commit in range(4):
        with ts.Transaction() as txn:
            for _ in range(150):
                key = (f"arr/{int(rng.integers(0, 600))}/"
                       f"{'k' * int(rng.integers(0, 20))}").encode()
                value = rng.integers(0, 256, int(rng.integers(0, 200))
                                     ).astype(np.uint8).tobytes()
                kv.with_transaction(txn)[key] = value
                want[key] = value
        if layout == "versions" and commit == 2:
            for key in sorted(want)[::5]:
                kv.delete_range(ts.KvStore.KeyRange(
                    key, key + b"\0")).result()
                del want[key]
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(want)
    for key, value in want.items():
        assert store.read(key) == value
    with pytest.raises(KeyError):
        store.read(b"arr/none")


def test_ocdbt_refusals(tmp_path):
    """A numbered manifest raises NotImplementedError; a flipped manifest
    byte, a flipped or truncated node and a missing data file raise
    OSError; a directory without a manifest ValueError."""
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path / 'numbered'}",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv[b"k"] = b"v"
    with pytest.raises(NotImplementedError, match="numbered"):
        ocdbt.OcdbtStore(str(tmp_path / "numbered"))
    with pytest.raises(ValueError, match="not an OCDBT store"):
        ocdbt.OcdbtStore(str(tmp_path))
    copy = tmp_path / "copy"
    shutil.copytree(FIXTURE, copy)
    manifest = copy / "manifest.ocdbt"
    good = manifest.read_bytes()
    manifest.write_bytes(good[:40] + bytes([good[40] ^ 4]) + good[41:])
    with pytest.raises(OSError, match="CRC"):
        ocdbt.OcdbtStore(str(copy))
    manifest.write_bytes(good)
    (node,) = (copy / "d").iterdir()
    data = node.read_bytes()
    node.write_bytes(data[:-9])
    with pytest.raises(OSError):
        ocdbt.OcdbtStore(str(copy))
    node.write_bytes(data[:30] + bytes([data[30] ^ 1]) + data[31:])
    with pytest.raises(OSError, match="CRC"):
        ocdbt.OcdbtStore(str(copy))
    node.write_bytes(data)
    store = ocdbt.OcdbtStore(str(copy))
    big = max(store.keys(), key=lambda k: len(store.read(k)))
    shutil.rmtree(copy / "ocdbt.process_0" / "d")
    with pytest.raises(OSError):
        store.read(big)


# -------------------------------------------------------------- restore

@pytest.mark.parametrize("name", ["gln_r5", "dihe_r4"])
def test_restore_trained_exports_match_orbax(name):
    assert_same_tree(port_restore(name), jax_restore(name))


def test_restore_fixture_matches_orbax_and_the_seed():
    got = orbax_read.restore(FIXTURE)
    assert_same_tree(got, _jax_restore_dir(FIXTURE))
    assert_same_tree(got, testing.orbax_fixture_tree())
    assert got["step"].shape == () and got["step"].dtype == np.int32
    assert isinstance(got["layers"], list)


def test_restore_value_types_match_orbax(tmp_path):
    """Python scalars, a bfloat16 jax.Array, a non-empty tuple (a list
    in orbax's restore) and the empty nodes orbax keeps (None, {}, [],
    ()), written by the JAX package's serving `_save`."""
    import jax.numpy as jnp

    from cvpce_tpu.pipeline.serving import _save

    tree = {"int": 3, "float": 2.5, "none": None, "dict": {}, "list": [],
            "tuple": (), "pair": (np.arange(3, dtype=np.int64),
                                  np.float32(1.5) * np.ones(2, np.float32)),
            "bf16": jnp.arange(5, dtype=jnp.bfloat16) / 3,
            "nested": {"f8": np.linspace(0, 1, 7), "b": np.array([True])}}
    _save(str(tmp_path / "ckpt"), tree)
    got = orbax_read.restore(str(tmp_path / "ckpt"))
    assert_same_tree(got, _jax_restore_dir(tmp_path / "ckpt"))
    assert got["bf16"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """A JAX GLN run (`checkpoint`, its `epoch_0`), a JAX DIHE run
    (`embedder_checkpoint`) and a JAX GAN pretraining run
    (`gan_checkpoint`), each written by cvpce_tpu/train/checkpoint.py's
    CheckpointManager from a train state: the GLN's from gln_r5's
    variables (SGD momentum included), the others from a seeded init at
    64x64 with a 4-level U-Net."""
    from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
    from cvpce_tpu.train import dihe as jdihe
    from cvpce_tpu.train import gln as jgln
    from cvpce_tpu.train.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("jax_runs")
    state, _ = jgln.init_train_state(
        JGLNConfig(canvas_h=64, canvas_w=64), jgln.GLNTrainConfig(),
        jax.random.PRNGKey(0), variables=jax_restore("gln_r5"))
    manager = CheckpointManager(str(root / "gln"))
    manager.save_rotating(state, {"epoch": 0})
    manager.save_named(state, "epoch_0", {"epoch": 0})
    state, _ = jdihe.init_dihe_state(jdihe.DIHETrainConfig(gen_downs=4),
                                     jax.random.PRNGKey(1), image_size=64)
    CheckpointManager(str(root / "dihe"),
                      name="embedder_checkpoint").save_rotating(
        state, {"epoch": 0})
    init, _ = jdihe.make_gan_pretrain_step(
        jdihe.GANPretrainConfig(gen_downs=4))
    CheckpointManager(str(root / "gan"), name="gan_checkpoint").save_rotating(
        init(jax.random.PRNGKey(2), gen_channels=3), {"epoch": 0})
    yield {k: str(root / k) for k in ("gln", "dihe", "gan")}
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("node", ["gln/checkpoint", "gln/epoch_0",
                                  "dihe/embedder_checkpoint",
                                  "gan/gan_checkpoint"])
def test_restore_jax_run_nodes_match_orbax(node, jax_runs):
    run, name = node.split("/")
    d = os.path.join(jax_runs[run], name)
    assert_same_tree(orbax_read.restore(d), _jax_restore_dir(d))


def _write_zarr(directory, name, spec, fill_region):
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "ocdbt",
                               "base": f"file://{directory}"},
                   "path": name, "metadata": spec},
                  create=True).result()
    rng = np.random.default_rng(len(name))
    data = rng.integers(-50, 50, spec["shape"]).astype(spec["dtype"]) \
        if spec["dtype"] != "|b1" else rng.random(spec["shape"]) < 0.5
    arr[fill_region] = data[fill_region]
    return arr


def test_zarr_chunk_grids_fill_values_and_dtypes(tmp_path):
    """Arrays that tensorstore's zarr driver writes into an OCDBT store
    with chunks smaller than the shape, ragged edge chunks, chunks never
    written (the fill_value, or zero for null) and every dtype the
    reader takes: restore reads what tensorstore reads."""
    specs = {
        "grid.f4": ({"shape": [7, 9], "chunks": [3, 4], "dtype": "<f4",
                     "fill_value": 1.5}, np.s_[:4, :]),
        "grid.i8": ({"shape": [5, 6, 7], "chunks": [2, 6, 3],
                     "dtype": "<i8", "fill_value": -3}, np.s_[1:, :, :4]),
        "f8": ({"shape": [10], "chunks": [4], "dtype": "<f8",
                "fill_value": None}, np.s_[:5]),
        "i4": ({"shape": [6, 2], "chunks": [6, 2], "dtype": "<i4",
                "fill_value": None}, np.s_[:]),
        "i1": ({"shape": [33], "chunks": [8], "dtype": "|i1",
                "fill_value": 7}, np.s_[8:20]),
        "u1": ({"shape": [4, 4], "chunks": [2, 2], "dtype": "|u1",
                "fill_value": 9}, np.s_[:2, :]),
        "b1": ({"shape": [20], "chunks": [6], "dtype": "|b1",
                "fill_value": True}, np.s_[:7]),
    }
    tree = {}
    for name, (spec, region) in specs.items():
        spec = {**spec, "compressor": {"id": "zstd", "level": 3}}
        arr = _write_zarr(tmp_path, name, spec, region)
        tree[f"('{name}',)"] = {
            "key_metadata": [{"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
        specs[name] = arr.read().result()
    (tmp_path / orbax_read.METADATA).write_text(json.dumps(
        {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False}))
    got = orbax_read.restore(str(tmp_path))
    for name, want in specs.items():
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("feature", ["blosc", "filters", "order_F",
                                     "big_endian", "separator", "zarr3",
                                     "no_ocdbt"])
def test_unread_zarr_features_raise_naming_them(feature, tmp_path):
    spec = {"shape": [4], "chunks": [4], "dtype": "<f4",
            "compressor": {"id": "zstd", "level": 1}}
    meta = {"use_ocdbt": True, "use_zarr3": False}
    if feature == "blosc":
        spec["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5,
                              "shuffle": 1}
    elif feature == "filters":
        spec["filters"] = [{"id": "delta", "dtype": "<f4"}]
    elif feature == "order_F":
        spec.update(shape=[2, 2], chunks=[2, 2], order="F")
    elif feature == "big_endian":
        spec["dtype"] = ">f4"
    elif feature == "separator":
        spec["dimension_separator"] = "/"
    elif feature == "zarr3":
        meta["use_zarr3"] = True
    elif feature == "no_ocdbt":
        meta["use_ocdbt"] = False
    if feature != "filters":
        _write_zarr(tmp_path, "x", spec, np.s_[:])
    else:  # tensorstore writes no filters: the .zarray alone
        ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}"}
                        ).result()[b"x/.zarray"] = json.dumps(
            {**spec, "zarr_format": 2, "order": "C",
             "fill_value": None}).encode()
    meta["tree_metadata"] = {"('x',)": {
        "key_metadata": [{"key": "x", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray",
                           "skip_deserialize": False}}}
    (tmp_path / orbax_read.METADATA).write_text(json.dumps(meta))
    words = {"blosc": "blosc", "filters": "filters", "order_F": "order",
             "big_endian": ">f4", "separator": "separator",
             "zarr3": "zarr v3", "no_ocdbt": "OCDBT"}
    with pytest.raises(NotImplementedError, match=words[feature]):
        orbax_read.restore(str(tmp_path))


# -------------------------------------------------------------- digests

def _digests():
    with open(os.path.join(REPO, testing.ORBAX_DIGESTS)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", OTHER_EXPORTS)
def test_other_exports_match_their_digests(name):
    assert testing.tree_digests(orbax_read.restore(export_dir(name))) \
        == _digests()[name]


@pytest.mark.parametrize("name", ["gln_r5", "dihe_r4"])
def test_digests_hold_to_orbax(name):
    """The digests file's gln_r5 and dihe_r4 entries are orbax's restore
    (so the file cannot go stale), and the port's restore gives them."""
    want = _digests()[name]
    assert testing.tree_digests(jax_restore(name)) == want
    assert testing.tree_digests(port_restore(name)) == want
    assert len(want) == {"gln_r5": 325, "dihe_r4": 78}[name]


# -------------------------------------------------------------- loaders

def test_trained_exports_through_the_loaders():
    """load_gln_variables(artifacts/gln_r5) and
    load_dihe_encoder(artifacts/dihe_r4) are the JAX loaders' trees
    through the bridges; the GLN loads strictly into the model, and a
    GLN export is refused as a DIHE encoder."""
    from cvpce_tpu.pipeline import serving as jserving
    from cvpce_tpu_torch.cli.common import (default_gln_config,
                                            load_gln_state_dict)
    from cvpce_tpu_torch.pipeline import serving
    from cvpce_tpu_torch.utils.weights import (gln_state_dict,
                                               macvgg_state_dict)

    gln = serving.load_gln_variables(GLN_DIR)
    _state(gln, gln_state_dict(jax.device_get(
        jserving.load_gln_variables(GLN_DIR))))
    _state(load_gln_state_dict(GLN_DIR, default_gln_config()), gln)
    params, stats = jax.device_get(jserving.load_dihe_encoder(DIHE_DIR))
    _state(serving.load_dihe_encoder(DIHE_DIR),
           macvgg_state_dict(params, stats))
    with pytest.raises(ValueError, match="looks like a GLN checkpoint"):
        serving.load_dihe_encoder(GLN_DIR)


def test_jax_run_nodes_through_the_loaders(jax_runs, tmp_path):
    """A JAX GLN run, its bare `epoch_0` node and its export to the
    port's layout load as JAX loads them; a JAX DIHE run gives its
    embedder; `dihe train --gan` takes a JAX GAN run's players; a DIHE
    run is no GLN checkpoint and a GLN run no DIHE encoder."""
    from cvpce_tpu.pipeline import serving as jserving
    from cvpce_tpu_torch.cli.common import (default_gln_config,
                                            load_gln_state_dict)
    from cvpce_tpu_torch.cli.dihe import load_gan_state
    from cvpce_tpu_torch.pipeline import serving
    from cvpce_tpu_torch.utils.weights import (gan_state_dict,
                                               gln_state_dict,
                                               macvgg_state_dict)

    run = jax_runs["gln"]
    want = gln_state_dict(jax.device_get(jserving.load_gln_variables(run)))
    _state(serving.load_gln_variables(run), want)
    _state(serving.load_gln_variables(run, name="epoch_0"), want)
    _state(load_gln_state_dict(os.path.join(run, "epoch_0"),
                               default_gln_config()), want)
    out = serving.export_gln_serving(run, str(tmp_path / "export"))
    assert not os.path.isdir(os.path.join(out, "serving_checkpoint"))
    _state(serving.load_gln_variables(out), want)
    drun = jax_runs["dihe"]
    params, stats = jax.device_get(jserving.load_dihe_encoder(drun))
    _state(serving.load_dihe_encoder(drun), macvgg_state_dict(params, stats))
    tree = _jax_restore_dir(os.path.join(jax_runs["gan"], "gan_checkpoint"))
    got = load_gan_state(jax_runs["gan"])
    _state(got["generator"], gan_state_dict(tree["gen_params"],
                                            tree["gen_stats"]))
    _state(got["discriminator"], gan_state_dict(tree["disc_params"],
                                                tree["disc_stats"]))
    with pytest.raises(ValueError, match=r"not a GLN checkpoint: missing"):
        serving.load_gln_variables(drun, name="embedder_checkpoint")
    with pytest.raises(ValueError, match="looks like a GLN checkpoint"):
        serving.load_dihe_encoder(run, name="checkpoint")
