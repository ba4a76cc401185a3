"""The port's orbax writer (cvpce_tpu_torch/utils/zstd.py:compress,
utils/ocdbt.py:write_store, utils/orbax_write.py:save), the inverse
weight bridges (utils/weights.py: gln_variables, macvgg_variables) and
the serving exports on them (pipeline/serving.py), against the libraries
the JAX package writes and reads with:

- the zstd frames decode with `zstandard` (libzstd) and with the port's
  decoder, with their content size and checksum;
- an OCDBT store the port writes reads in tensorstore's `ocdbt` kvstore,
  key for key, in orbax's config, and empty; a node over its limit
  raises; the writer's config is what the port's reader finds in gln_r5's
  manifest;
- `save` of `testing.orbax_fixture_tree` and of every dtype it takes is
  restored by `ocp.StandardCheckpointer().restore` bit for bit (leaf,
  dtype, shape), as the port's reader restores it; an unwritable leaf
  raises naming it and leaves nothing behind; a checkpoint at the target
  is replaced, any other directory there refused;
- the bridges give the trained exports' trees back, key path and dtype;
- the port's exports of a port-trained 64x64 GLN run and a DIHE run are
  read by the JAX package's loaders, bit for bit, and JAX's forward on
  them equals the port's within the f32 bound of
  tests/test_torch_serving_paths.py (1e-4 of the largest magnitude);
- the port's rewrite of gln_r5, restored by orbax, matches
  tests/torch_fixtures/orbax_digests.json.
"""
import json
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import zstandard

from test_torch_orbax import _tensorstore, assert_same_tree
from test_torch_train_gln import H, W, TRAIN_KW, step_batch
from torch_eval_common import REPO, export_dir, jax_restore

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.utils import ocdbt, orbax_read, orbax_write, zstd
from cvpce_tpu_torch.utils.weights import (gln_state_dict, gln_variables,
                                           macvgg_state_dict,
                                           macvgg_variables)

F32_BOUND = 1e-4


def rel_err(got, want):
    """Largest |got - want| over the largest |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_same_weights(got, want):
    """Every tensor equal but BatchNorm's `num_batches_tracked`, a
    counter that flax does not keep and nothing of the port reads (its
    BatchNorm's momentum is fixed): the bridge gives 0."""
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 0, k
        else:
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def orbax_restore(directory):
    return ocp.StandardCheckpointer().restore(os.path.abspath(directory))


# ----------------------------------------------------------------- zstd

@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, 131072,
                                  131073, 400000])
def test_zstd_frames_decode_in_libzstd_and_the_port(size):
    """Sizes on each side of the 1-, 2- and 4-byte content-size fields
    and of the 128 KiB block."""
    data = np.random.default_rng(size).integers(0, 256, size).astype(
        np.uint8).tobytes()
    frame = zstd.compress(data)
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == size and params.has_checksum
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data == zstd.decompress(frame, size)
    # raw blocks: the frame is the data and a few bytes of framing
    assert len(frame) - size <= 17 + 3 * (size // zstd.BLOCK_MAX)


def test_zstd_frame_checksum_is_checked():
    frame = bytearray(zstd.compress(b"shelf " * 100))
    frame[-1] ^= 1
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(bytes(frame))
    with pytest.raises(OSError):
        zstd.decompress(bytes(frame))


# ---------------------------------------------------------------- OCDBT

def _items(n=600, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for _ in range(n):
        key = (f"arr/{int(rng.integers(0, 600))}/"
               f"{'k' * int(rng.integers(0, 20))}").encode()
        out[key] = rng.integers(0, 256, int(rng.integers(0, 3000))).astype(
            np.uint8).tobytes()
    return out


@pytest.mark.parametrize("layout", ["orbax", "empty"])
def test_ocdbt_store_reads_in_tensorstore(layout, tmp_path):
    """Orbax's config (one leaf node of 594 keys, values over 1 KB in
    the data file) and a store of no key."""
    want = {} if layout == "empty" else _items()
    stats = ocdbt.write_store(str(tmp_path), want.items())
    assert stats["keys"] == len(want)
    assert stats["nodes"] == (layout == "orbax")
    kv = _tensorstore(str(tmp_path))
    keys = kv.list().result()
    assert sorted(keys) == sorted(want)
    for key in keys:
        assert kv.read(key).result().value == want[key]
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(want)
    assert store.config == ocdbt.ORBAX_CONFIG
    with pytest.raises(ValueError, match="already holds"):
        ocdbt.write_store(str(tmp_path), [])


def test_ocdbt_node_over_its_limit_raises(tmp_path, monkeypatch):
    """The writer puts every key in one leaf node; keys whose node
    would pass the limit raise (a 1 KB limit here: at orbax's 100 MB a
    serving export's node takes a few tens of KB)."""
    monkeypatch.setitem(ocdbt.ORBAX_CONFIG, "max_decoded_node_bytes", 1024)
    with pytest.raises(ValueError, match="over the limit of 1024"):
        ocdbt.write_store(str(tmp_path), _items().items())


def test_ocdbt_writer_config_is_orbax_s():
    """The config the writer puts in its manifests is the one orbax
    wrote into the trained exports, as the port's reader reads it."""
    for name in ("gln_r5", "dihe_r4"):
        assert ocdbt.OcdbtStore(export_dir(name)).config == \
            ocdbt.ORBAX_CONFIG


# ---------------------------------------------------------------- orbax

def value_tree():
    """Every dtype the writer takes, beside the seeded fixture."""
    tree = testing.orbax_fixture_tree()
    tree.update({
        "bf16": np.arange(4).astype(ml_dtypes.bfloat16),
        "numpy": {"f16": np.ones(2, np.float16),
                  "u32": np.arange(3, dtype=np.uint32),
                  "i64": np.arange(4, dtype=np.int64),
                  "f64": np.float64(1.5), "i8": np.int8(-3),
                  "strided": np.arange(12, dtype=np.int16).reshape(3, 4)[:, ::2]},
    })
    return tree


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("orbax_write") / "ckpt")
    stats = orbax_write.save(d, value_tree())
    yield d, stats
    shutil.rmtree(d, ignore_errors=True)


def test_orbax_restores_what_the_port_writes(written):
    """Every leaf bit for bit, dtype and shape; numpy scalars come back
    as 0-d arrays."""
    d, stats = written
    want = value_tree()
    got = orbax_restore(d)
    want["numpy"] = {k: np.asarray(v) for k, v in want["numpy"].items()}
    assert_same_tree(got, want)
    assert stats["array_bytes"] == sum(
        np.asarray(v).nbytes for _, v in testing.tree_leaves(want))


def test_port_reads_what_the_port_writes_as_orbax_does(written):
    d, _ = written
    assert_same_tree(orbax_read.restore(d), orbax_restore(d))


def test_written_layout_is_orbax_s(tmp_path):
    """On the fixture's tree of numpy leaves: `_METADATA` equal to orbax's (leaf order included), the
    same zarr keys, `.zarray` bytes and decoded chunks, and
    `_CHECKPOINT_METADATA`'s keys and handler; the port writes the root
    store alone, where orbax adds `ocdbt.process_0/`."""
    tree = testing.orbax_fixture_tree()
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "orbax")
    orbax_write.save(mine, tree)
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(theirs, tree)
    checkpointer.wait_until_finished()
    for name in (orbax_read.METADATA, orbax_write.CHECKPOINT_METADATA):
        with open(os.path.join(mine, name)) as f, open(os.path.join(
                theirs, name)) as g:
            got, want = json.load(f), json.load(g)
        if name == orbax_read.METADATA:
            assert list(got.items()) == list(want.items())
            assert list(got["tree_metadata"]) == list(want["tree_metadata"])
        else:
            assert set(got) == set(want)
            assert got["item_handlers"] == want["item_handlers"]
    a, b = ocdbt.OcdbtStore(mine), ocdbt.OcdbtStore(theirs)
    assert a.keys() == b.keys()
    for key in a.keys():
        if key.endswith(b"/.zarray"):
            assert a.read(key) == b.read(key), key
        else:
            assert zstd.decompress(a.read(key)) == zstd.decompress(
                b.read(key)), key
    assert sorted(os.listdir(mine)) == ["_CHECKPOINT_METADATA",
                                        "_METADATA", "d", "manifest.ocdbt"]
    assert "ocdbt.process_0" in os.listdir(theirs)


@pytest.mark.parametrize("leaf", ["complex", "object", "str", "size_0",
                                  "torch", "int_key", "big_endian",
                                  "python_int", "tuple", "empty_list"])
def test_unwritable_leaves_raise_naming_them(leaf, tmp_path):
    value = {"complex": np.ones(2, np.complex64),
             "object": np.array([None, 1], object),
             "str": "shelf", "size_0": np.zeros((0, 3), np.float32),
             "torch": torch.ones(2),
             "int_key": {1: np.ones(2)},
             "big_endian": np.arange(3, dtype=">f4"),
             "python_int": 3, "tuple": (np.ones(2),), "empty_list": []}[leaf]
    target = str(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="params.bad" if leaf != "int_key"
                       else "params.bad: dict key 1"):
        orbax_write.save(target, {"params": {"bad": value,
                                             "good": np.ones(3)}})
    assert os.listdir(tmp_path) == []


def test_save_replaces_a_checkpoint_and_refuses_other_directories(
        tmp_path):
    """A checkpoint at the target is replaced (renamed aside, the new
    one moved in, the old one removed); a directory that holds no
    checkpoint is left as it is."""
    target = str(tmp_path / "ckpt")
    orbax_write.save(target, {"a": np.zeros(3, np.float32)})
    orbax_write.save(target, {"b": np.ones(2, np.int32)})
    assert_same_tree(orbax_restore(target), {"b": np.ones(2, np.int32)})
    assert os.listdir(tmp_path) == ["ckpt"]
    other = tmp_path / "other"
    other.mkdir()
    (other / "notes.txt").write_text("shelf")
    with pytest.raises(ValueError, match="holds no orbax checkpoint"):
        orbax_write.save(str(other), {"a": np.zeros(3, np.float32)})
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "other"]
    assert os.listdir(other) == ["notes.txt"]


# -------------------------------------------------------------- bridges

def test_gln_variables_invert_gln_state_dict():
    """gln_r5's tree through the bridge and back, key path and dtype
    (assert_same_tree holds structure, dtype, shape and bytes)."""
    v = jax_restore("gln_r5")
    assert_same_tree(gln_variables(gln_state_dict(v)), v)


def test_macvgg_variables_invert_macvgg_state_dict():
    v = jax_restore("dihe_r4")
    params, stats = macvgg_variables(macvgg_state_dict(v["params"],
                                                       v["batch_stats"]))
    assert_same_tree({"params": params, "batch_stats": stats}, v)


def test_bridges_refuse_a_foreign_state_dict():
    sd = {"features.0.weight": torch.zeros(2, 3, 3, 3),
          "head.conv.weight": torch.zeros(2, 3, 3, 3)}
    with pytest.raises(KeyError, match="not a MACVGG layer: head.conv"):
        macvgg_variables(sd)
    with pytest.raises(KeyError, match="unexpected state_dict entry"):
        gln_variables({"body.conv1.scale": torch.zeros(3)})


# ---------------------------------------------------- exports into JAX

@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """A port GLN run one SGD step past the seeded reference weights
    (64x64, tanh), with a calibration file, and a port DIHE run one step
    past a seeded init; each exported by the port."""
    from cvpce_tpu_torch.cli.common import load_gln_state_dict
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.pipeline.calibrate import save_calibration
    from cvpce_tpu_torch.pipeline.serving import (export_dihe_serving,
                                                  export_gln_serving)
    from cvpce_tpu_torch.train import dihe as pdihe
    from cvpce_tpu_torch.train import gln as ptrain
    from cvpce_tpu_torch.train.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("port_runs")
    cfg = GLNConfig(canvas_h=H, canvas_w=W, tanh=True)
    tcfg = ptrain.GLNTrainConfig(**TRAIN_KW)
    reference = str(root / "gln_reference.pth")
    torch.save({"model_state_dict": testing.gln_reference_state_dict(
        np.random.default_rng(5))}, reference)
    state = ptrain.init_train_state(
        cfg, tcfg, state_dict=load_gln_state_dict(reference, cfg),
        device="cpu")
    state, _ = ptrain.make_train_step(cfg, tcfg, cfg.anchors()[0])(
        state, *step_batch())
    CheckpointManager(str(root / "gln")).save_rotating(state, {"epoch": 0})
    save_calibration(str(root / "gln"), {"threshold": 0.4,
                                         "input_norm": "raw01"})
    dcfg = pdihe.DIHETrainConfig(gen_downs=4, steps_per_epoch=10)
    dstate = pdihe.init_dihe_state(dcfg, seed=3, device="cpu")
    rng = np.random.default_rng(0)
    batch = [rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
             for _ in range(4)]
    dstate, _ = pdihe.make_dihe_train_step(dcfg)(
        dstate, batch[0], batch[1], batch[2], batch[3],
        np.array([0.5, 1.0], np.float32))
    CheckpointManager(str(root / "dihe"), name="embedder_checkpoint"
                      ).save_rotating(dstate, {"epoch": 0})
    out = {"gln": export_gln_serving(str(root / "gln"),
                                     str(root / "gln_export")),
           "dihe": export_dihe_serving(str(root / "dihe"),
                                       str(root / "dihe_export")),
           "gln_model": state.model, "dihe_model": dstate.embedder}
    for run in ("gln", "dihe"):
        shutil.rmtree(root / run)  # 0.3 GB with the optimizer states
    yield out
    shutil.rmtree(root, ignore_errors=True)


def test_jax_serves_the_port_s_gln_export(port_runs):
    """JAX's load_gln_variables reads the export; its weights are the
    port's bit for bit, its calibration sidecar resolves, and JAX's f32
    forward on them equals the port's."""
    from cvpce_tpu.models.gln import GLN as JGLN
    from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
    from cvpce_tpu.pipeline.calibrate import resolve_threshold
    from cvpce_tpu.pipeline.serving import load_gln_variables

    model = port_runs["gln_model"].eval()
    variables = jax.device_get(load_gln_variables(port_runs["gln"]))
    assert_same_weights(gln_state_dict(variables), model.state_dict())
    assert resolve_threshold("auto", port_runs["gln"]) == pytest.approx(0.4)
    x = np.random.default_rng(1).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    want = jax.jit(JGLN(config=JGLNConfig(canvas_h=H, canvas_w=W, tanh=True),
                        train=False).apply)(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression", "gaussians"):
        assert rel_err(got[key].numpy(), np.asarray(want[key])) <= F32_BOUND


def test_jax_serves_the_port_s_dihe_export(port_runs):
    from cvpce_tpu.models.embedders import MACVGG as JMACVGG
    from cvpce_tpu.pipeline.serving import load_dihe_encoder

    model = port_runs["dihe_model"].eval()
    params, stats = jax.device_get(load_dihe_encoder(port_runs["dihe"]))
    assert_same_weights(macvgg_state_dict(params, stats), model.state_dict())
    crops = np.random.default_rng(2).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(JMACVGG(batch_norm=True).apply)(
        {"params": params, "batch_stats": stats}, crops)
    with torch.no_grad():
        got = model(torch.from_numpy(crops))
    assert rel_err(got.numpy(), np.asarray(want)) <= F32_BOUND


def test_rewritten_gln_r5_matches_its_digests(tmp_path):
    """The port reads gln_r5 and writes it again through the serving
    export; orbax's restore of the rewrite has the committed digests."""
    from cvpce_tpu_torch.pipeline.serving import (export_gln_serving,
                                                  load_gln_variables)

    # gln_r5 as the `checkpoint` node of a run, beside its sidecar
    run = tmp_path / "run"
    run.mkdir()
    os.symlink(export_dir("gln_r5"), run / "checkpoint")
    calibration = os.path.join(os.path.dirname(export_dir("gln_r5")),
                               "serving_calibration.json")
    shutil.copyfile(calibration, run / "serving_calibration.json")
    out = export_gln_serving(str(run), str(tmp_path / "rewrite"))
    with open(os.path.join(REPO, testing.ORBAX_DIGESTS)) as f:
        digests = json.load(f)["gln_r5"]
    restored = orbax_restore(os.path.join(out, "serving_checkpoint"))
    assert testing.tree_digests(restored) == digests
    with open(calibration, "rb") as f, open(os.path.join(
            out, "serving_calibration.json"), "rb") as g:
        assert f.read() == g.read()
    sd = load_gln_variables(out)
    for k, v in load_gln_variables(str(run)).items():
        assert torch.equal(sd[k], v), k
