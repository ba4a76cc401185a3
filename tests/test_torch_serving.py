"""The port's serving exports and directory loaders
(cvpce_tpu_torch/pipeline/serving.py, cli/common.py, the GLN loop's
`load_orbax`) against the JAX package's (cvpce_tpu/pipeline/serving.py):
export -> load gives the state bit for bit, in the JAX package's orbax
layout and trees, the sidecars byte for byte,
the default-name shortcut follows JAX's rule, a GLN export is refused as
a DIHE encoder, and an orbax directory that JAX's `_save` wrote loads
as JAX loads it. Then `gln eval --weights <dir>` and `dihe eval
--weights <dir>` through the port (its own export) and through JAX's
click commands (an orbax export of the same numpy weights), and `gln
eval`, `dihe eval` and `eval-planograms` on the trained exports
artifacts/gln_r5 and artifacts/dihe_r4 through both, on the files of
tests/torch_cli_common.py at a 64x64 canvas.

Tolerances: states are equal bit for bit; the printed JSON is equal
(metrics and accuracies, the same forward as tests/test_torch_cli_eval.py
holds, whose `c` is within 1e-6 of JAX's: 6e-7 measured).
"""
import os
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from torch_cli_common import json_of, small_args, write_inputs

from cvpce_tpu_torch.utils import orbax_read
from cvpce_tpu_torch.utils.weights import gln_state_dict, macvgg_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCORE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_train_dihe_loops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def remove_outputs(request):
    """Each test's tmp_path goes when the test ends: the checkpoints and
    exports written by these tests take hundreds of MB."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    f = write_inputs(tmp_path_factory.mktemp("serving"), seed=1)
    yield f
    shutil.rmtree(f["root"], ignore_errors=True)


def port_cli(args) -> str:
    import contextlib
    import io

    from cvpce_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--device", "cpu"] + list(args)) == 0
    return out.getvalue()


def _config():
    from cvpce_tpu_torch.models.gln import GLNConfig

    return GLNConfig(canvas_h=64, canvas_w=64, max_nms_candidates=128,
                     detections_per_img=64)


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def gln_run(files, tmp_path_factory):
    """A port GLN training run: the reference checkpoint's weights in a
    GLNTrainState, saved by CheckpointManager, with a calibration file."""
    from cvpce_tpu_torch.cli.common import load_gln_state_dict
    from cvpce_tpu_torch.pipeline.calibrate import save_calibration
    from cvpce_tpu_torch.train import gln as gln_train
    from cvpce_tpu_torch.train.checkpoint import CheckpointManager

    run = str(tmp_path_factory.mktemp("gln_run"))
    state = gln_train.init_train_state(
        _config(), gln_train.GLNTrainConfig(), 0,
        state_dict=load_gln_state_dict(files["gln"], _config()),
        device="cpu")
    manager = CheckpointManager(run)
    manager.save_rotating(state, {"epoch": 3, "ap": 0.5})
    manager.save_named(state, "epoch_3", {"epoch": 3})
    save_calibration(run, {"threshold": 0.62, "input_norm": "raw01"})
    yield run, state.model.state_dict()
    shutil.rmtree(run, ignore_errors=True)


@pytest.fixture(scope="module")
def dihe_run(tmp_path_factory):
    from cvpce_tpu_torch.train.checkpoint import CheckpointManager
    from cvpce_tpu_torch.train.dihe import DIHETrainConfig, init_dihe_state

    run = str(tmp_path_factory.mktemp("dihe_run"))
    state = init_dihe_state(DIHETrainConfig(gen_downs=4), seed=3,
                            device="cpu")
    CheckpointManager(run, name="embedder_checkpoint").save_rotating(
        state, {"epoch": 7})
    yield run, state.embedder.state_dict()
    shutil.rmtree(run, ignore_errors=True)


def test_gln_export_round_trip(gln_run, tmp_path):
    from cvpce_tpu_torch.pipeline.calibrate import (resolve_input_norm,
                                                    resolve_threshold)
    from cvpce_tpu_torch.pipeline.serving import (export_gln_serving,
                                                  load_gln_variables,
                                                  load_serving_meta)

    run, want = gln_run
    out = str(tmp_path / "artifact")
    assert export_gln_serving(run, out) == out
    _assert_same_state(load_gln_variables(out), want)
    _assert_same_state(load_gln_variables(run), want)
    # the model only, in the JAX package's orbax layout and trees: no
    # SGD buffers, no step
    saved = orbax_read.restore(os.path.join(out, "serving_checkpoint"))
    assert sorted(saved) == ["batch_stats", "frozen", "params"]
    _assert_same_state(gln_state_dict(saved), want)
    assert resolve_threshold("auto", out) == pytest.approx(0.62)
    assert resolve_input_norm(out, default="imagenet") == "raw01"
    assert load_serving_meta(out) == {"epoch": 3, "ap": 0.5}
    assert load_serving_meta(run) == {}


def test_sidecars_are_byte_equal(gln_run, dihe_run, tmp_path):
    from cvpce_tpu_torch.pipeline.serving import (export_dihe_serving,
                                                  export_gln_serving)

    def read(p):
        with open(p, "rb") as f:
            return f.read()

    run, _ = gln_run
    out = str(tmp_path / "gln")
    export_gln_serving(run, out, name="epoch_3")
    assert read(os.path.join(out, "serving_calibration.json")) == read(
        os.path.join(run, "serving_calibration.json"))
    assert read(os.path.join(out, "serving_checkpoint.meta.json")) == read(
        os.path.join(run, "epoch_3.meta.json"))
    run, _ = dihe_run
    out = str(tmp_path / "dihe")
    export_dihe_serving(run, out)
    assert read(os.path.join(out, "serving_checkpoint.meta.json")) == read(
        os.path.join(run, "embedder_checkpoint.meta.json"))
    assert not os.path.exists(os.path.join(out, "serving_calibration.json"))


def test_dihe_export_round_trip(dihe_run, tmp_path):
    from cvpce_tpu_torch.pipeline.serving import (export_dihe_serving,
                                                  load_dihe_encoder,
                                                  load_serving_meta)

    run, want = dihe_run
    out = str(tmp_path / "artifact")
    export_dihe_serving(run, out)
    _assert_same_state(load_dihe_encoder(out), want)
    _assert_same_state(load_dihe_encoder(run), want)
    # the encoder only, in the JAX package's orbax layout and trees: the
    # GAN players and the optimizers stay behind
    saved = orbax_read.restore(os.path.join(out, "serving_checkpoint"))
    assert sorted(saved) == ["batch_stats", "params"]
    _assert_same_state(macvgg_state_dict(saved["params"],
                                         saved["batch_stats"]), want)
    assert load_serving_meta(out)["epoch"] == 7


def test_default_name_shortcut_follows_jax(gln_run, tmp_path):
    """A serving export beside a run's checkpoints serves the default
    name only: a named node is that node (JAX's rule, serving.py:100-112).
    """
    from cvpce_tpu_torch.pipeline.serving import (SERVING_NAME,
                                                  export_gln_serving,
                                                  load_gln_variables)

    run, want = gln_run
    both = str(tmp_path / "both")
    shutil.copytree(run, both)
    other = {k: v + 1 if v.is_floating_point() else v
             for k, v in want.items()}
    torch.save({"model": other}, os.path.join(both, SERVING_NAME))
    _assert_same_state(load_gln_variables(both), other)
    _assert_same_state(load_gln_variables(both, name="epoch_3"), want)
    _assert_same_state(load_gln_variables(both, name="checkpoint"), other)
    # an export of a named node exports that node
    export_gln_serving(both, str(tmp_path / "node"), name="epoch_3")
    _assert_same_state(load_gln_variables(str(tmp_path / "node")), want)
    # exporting over the port's earlier torch.save export replaces it
    # with the orbax one
    old = tmp_path / "old"
    old.mkdir()
    torch.save({"model": other}, os.path.join(old, SERVING_NAME))
    export_gln_serving(both, str(old), name="epoch_3")
    assert os.path.isdir(os.path.join(old, SERVING_NAME))
    _assert_same_state(load_gln_variables(str(old)), want)


def test_refusals(gln_run, dihe_run, tmp_path):
    """A GLN export or run is no DIHE encoder; a DIHE run is no GLN; what
    is missing is named."""
    from cvpce_tpu_torch.pipeline.serving import (export_gln_serving,
                                                  load_dihe_encoder,
                                                  load_gln_variables)

    run, _ = gln_run
    out = str(tmp_path / "gln")
    export_gln_serving(run, out)
    for d, name in ((out, "embedder_checkpoint"), (run, "checkpoint")):
        with pytest.raises(ValueError, match="looks like a GLN"):
            load_dihe_encoder(d, name=name)
    drun, _ = dihe_run
    with pytest.raises(ValueError, match=r"not a GLN checkpoint: missing "
                                         r"\['model'\]"):
        load_gln_variables(drun, name="embedder_checkpoint")
    with pytest.raises(ValueError, match="no checkpoint file"):
        load_gln_variables(str(tmp_path))
    with pytest.raises(ValueError, match="no checkpoint file"):
        load_dihe_encoder(run)


def test_orbax_directories_load_as_jax_loads_them(gln_run, exports,
                                                  tmp_path):
    """The JAX package's orbax layouts (a serving export, a run's
    `checkpoint` node, a bare node), which the port refused until it had
    an orbax reader of its own (ROADMAP.md, Queue 1 item 7), now load
    through every port loader as the JAX loaders load them: the state
    bridged by utils/weights.py, bit for bit, equal to the port's import
    of the same reference weights; a GLN export is refused as an
    embedder, and the GLN loop warm-starts from the export."""
    import jax

    from cvpce_tpu.pipeline import serving as jserving
    from cvpce_tpu_torch.cli.common import load_embedder, load_gln_state_dict
    from cvpce_tpu_torch.pipeline.serving import (load_dihe_encoder,
                                                  load_gln_variables)
    from cvpce_tpu_torch.train import gln as gln_train
    from cvpce_tpu_torch.train.loops import train_proposal_generator
    from cvpce_tpu_torch.utils.weights import (gln_state_dict,
                                               macvgg_state_dict)

    _, port_state = gln_run
    export, run_dir = exports["jax_gln"], tmp_path / "run"
    run_dir.mkdir()
    shutil.copytree(os.path.join(export, "serving_checkpoint"),
                    run_dir / "checkpoint")
    node = str(run_dir / "checkpoint")
    want = gln_state_dict(jax.device_get(jserving.load_gln_variables(export)))
    _assert_same_state(want, port_state)
    for d in (export, str(run_dir)):
        _assert_same_state(load_gln_variables(d), want)
        _assert_same_state(load_gln_state_dict(d, _config()), want)
    _assert_same_state(load_gln_state_dict(node, _config()), want)
    for loader in (load_dihe_encoder,
                   lambda d: load_embedder(d, device="cpu")):
        with pytest.raises(ValueError, match="looks like a GLN"):
            loader(export)
    params, stats = jax.device_get(
        jserving.load_dihe_encoder(exports["jax_dihe"]))
    _assert_same_state(load_dihe_encoder(exports["jax_dihe"]),
                       macvgg_state_dict(params, stats))
    _assert_same_state(
        load_embedder(exports["jax_dihe"], device="cpu")[0]
        .model.state_dict(),
        load_embedder(exports["port_dihe"], device="cpu")[0]
        .model.state_dict())
    started = []

    def init(*args, state_dict=None, **kwargs):
        started.append(state_dict)
        raise StopIteration  # the start is all this test needs

    for d in (export, str(run_dir)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gln_train, "init_train_state", init)
            with pytest.raises(StopIteration):
                train_proposal_generator(
                    [], [], str(tmp_path / "out"), model_cfg=_config(),
                    load_orbax=d, device="cpu")
        _assert_same_state(started.pop(), want)


def test_loop_warm_starts_from_a_port_directory(files, gln_run, tmp_path):
    """train_proposal_generator(load_orbax=<export or run>) starts from
    the directory's model, as JAX's loop starts from its orbax export
    (loops.py:143-151): the first step's weights are the directory's."""
    from cvpce_tpu_torch.pipeline.serving import export_gln_serving
    from cvpce_tpu_torch.train import gln as gln_train
    from cvpce_tpu_torch.train import loops

    run, want = gln_run
    out = str(tmp_path / "artifact")
    export_gln_serving(run, out)
    started = []

    def init(*args, state_dict=None, **kwargs):
        started.append(state_dict)
        raise StopIteration  # the start is all this test needs

    for d in (out, run):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gln_train, "init_train_state", init)
            with pytest.raises(StopIteration):
                loops.train_proposal_generator(
                    [], [], str(tmp_path / "o"), model_cfg=_config(),
                    load_orbax=d, device="cpu")
        _assert_same_state(started.pop(), want)


def test_cli_loaders_read_port_directories(files, gln_run, dihe_run,
                                           tmp_path):
    """A run directory, a serving export and a bare node file load as
    the state they hold; an embedder from a DIHE directory is served
    folded, as from its checkpoint file."""
    from cvpce_tpu_torch.cli.common import load_embedder, load_gln_state_dict
    from cvpce_tpu_torch.pipeline.serving import (export_dihe_serving,
                                                  export_gln_serving)

    run, want = gln_run
    out = str(tmp_path / "gln")
    export_gln_serving(run, out)
    for src in (run, out, os.path.join(run, "epoch_3")):
        _assert_same_state(load_gln_state_dict(src, _config()), want)
    drun, _ = dihe_run
    dout = str(tmp_path / "dihe")
    export_dihe_serving(drun, dout)
    want_fold = load_embedder(os.path.join(drun, "embedder_checkpoint"),
                              device="cpu")[0].model.state_dict()
    for src in (drun, dout):
        _assert_same_state(load_embedder(src, device="cpu")[0]
                           .model.state_dict(), want_fold)


# ------------------------------------- the same weights through JAX

@pytest.fixture(scope="module")
def exports(files, tmp_path_factory):
    """The reference GLN and vgg16_bn weights as a port export (through
    a port training run) and as a JAX orbax export of the same numpy
    arrays."""
    import jax
    import jax.numpy as jnp

    from cvpce_tpu.cli import common as jcommon
    from cvpce_tpu.models.embedders import MACVGG as JMACVGG
    from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
    from cvpce_tpu.pipeline import serving as jserving
    from cvpce_tpu.utils import torch_import as jimport
    from cvpce_tpu_torch.cli.common import _merge, load_gln_state_dict
    from cvpce_tpu_torch.models.embedders import MACVGG
    from cvpce_tpu_torch.pipeline.serving import (export_dihe_serving,
                                                  export_gln_serving)
    from cvpce_tpu_torch.utils.torch_import import (import_vgg16_features,
                                                    load_state_dict)

    root = tmp_path_factory.mktemp("exports")
    out = {}
    # GLN
    run = root / "port_gln_run"
    run.mkdir()
    torch.save({"model": load_gln_state_dict(files["gln"], _config()),
                "optimizer": {}, "step": 0}, run / "checkpoint")
    out["port_gln"] = export_gln_serving(str(run), str(root / "port_gln"))
    jvars = jcommon.load_gln_variables(
        files["gln"], JGLNConfig(canvas_h=64, canvas_w=64))
    (root / "jax_gln").mkdir()
    jserving._save(str(root / "jax_gln" / "serving_checkpoint"),
                   jax.device_get(dict(jvars)))
    out["jax_gln"] = str(root / "jax_gln")
    # DIHE encoder, BatchNorm unfolded as training leaves it
    sd = load_state_dict(files["vgg"])
    model = MACVGG(batch_norm=True,
                   generator=torch.Generator().manual_seed(0))
    run = root / "port_dihe_run"
    run.mkdir()
    torch.save({"embedder": _merge(model.state_dict(),
                                   import_vgg16_features(sd, True)),
                "step": 0}, run / "embedder_checkpoint")
    out["port_dihe"] = export_dihe_serving(str(run), str(root / "port_dihe"))
    jmodel = JMACVGG(batch_norm=True, train=False)
    jvars = jmodel.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 3), jnp.float32))
    jvars = jcommon._merge(dict(jvars), jimport.import_vgg16_features(
        jimport.load_state_dict(files["vgg"]), batch_norm=True))
    (root / "jax_dihe").mkdir()
    jserving._save(str(root / "jax_dihe" / "serving_checkpoint"),
                   jax.device_get({"params": jvars["params"],
                                   "batch_stats": jvars["batch_stats"]}))
    out["jax_dihe"] = str(root / "jax_dihe")
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _commands(f, weights_gln, weights_dihe):
    return {
        "gln": ["gln", "eval", "--imgs", f["sku_imgs"], "--annotations",
                f["sku_ann"], "--weights", weights_gln] + small_args(),
        "dihe": ["dihe", "eval", "--source", f["source"], "--test-imgs",
                 f["test_imgs"], "--test-annotations", f["test_ann"],
                 "--weights", weights_dihe, "--batch-size", "8", "--k", "1",
                 "--k", "3"],
    }


@pytest.fixture(scope="module")
def jax_outputs(files, exports):
    from cvpce_tpu.cli import cli

    outputs = {}
    for name, args in _commands(files, exports["jax_gln"],
                                exports["jax_dihe"]).items():
        res = CliRunner().invoke(cli, args, catch_exceptions=False)
        assert res.exit_code == 0, res.output
        outputs[name] = json_of(res.output)
    return outputs


def _assert_same(got, want, key=""):
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _assert_same(got[k], want[k], k)
    elif key == "c":
        assert abs(got - want) <= SCORE_TOL, (key, got, want)
    else:
        assert got == want, (key, got, want)


@pytest.mark.parametrize("name", ["gln", "dihe"])
def test_eval_weights_directory_matches_jax(name, files, exports,
                                            jax_outputs):
    """`gln eval` / `dihe eval --weights <port export>` print what JAX's
    print with `--weights <its orbax export>` of the same weights, and
    the port's run directory prints the same."""
    cmds = _commands(files, exports["port_gln"], exports["port_dihe"])
    got = json_of(port_cli(cmds[name]))
    _assert_same(got, jax_outputs[name])
    run = os.path.join(os.path.dirname(exports[f"port_{name}"]),
                       f"port_{name}_run")
    cmds = _commands(files, run, run)
    assert json_of(port_cli(cmds[name])) == got
    if name == "dihe":
        assert 0 < got["1"] <= got["3"] <= 1, got
    else:
        assert got["0.5"]["ap"] > 0, got


# ------------------------------------------- the trained exports

TRAINED = {"gln": os.path.join(REPO, "artifacts", "gln_r5"),
           "dihe": os.path.join(REPO, "artifacts", "dihe_r4")}


def _trained_commands(f):
    commands = _commands(f, TRAINED["gln"], TRAINED["dihe"])
    commands["planograms"] = [
        "eval-planograms", "--test-imgs", f["test_imgs"],
        "--test-annotations", f["test_ann"], "--planograms", f["planos"],
        "--gln-weights", TRAINED["gln"], "--encoder-weights",
        TRAINED["dihe"], "--source", f["source"], "--verbose"] + small_args()
    return commands


@pytest.fixture(scope="module")
def jax_trained_outputs(files):
    from cvpce_tpu.cli import cli

    from torch_cli_common import jax_models_built_once

    outputs = {}
    with jax_models_built_once():
        for name, args in _trained_commands(files).items():
            res = CliRunner().invoke(cli, args, catch_exceptions=False)
            assert res.exit_code == 0, res.output
            outputs[name] = json_of(res.output)
    return outputs


@pytest.mark.parametrize("name", ["gln", "dihe", "planograms"])
def test_trained_exports_eval_matches_jax(name, files, jax_trained_outputs):
    """`gln eval --weights artifacts/gln_r5`, `dihe eval --weights
    artifacts/dihe_r4` and `eval-planograms` with both, read by the
    port's own orbax reader (the calibrated threshold from the export's
    serving_calibration.json), print what JAX's click commands print on
    the same files."""
    got = json_of(port_cli(_trained_commands(files)[name]))
    _assert_same(got, jax_trained_outputs[name])


def test_gln_train_load_warm_starts_from_the_trained_export(files,
                                                            tmp_path):
    """`gln train --load artifacts/gln_r5` starts from the export's
    model, read by the port's own orbax reader, as JAX's `gln train
    --load` starts from its orbax restore: the first step's weights are
    JAX's load through the bridge, bit for bit."""
    import jax

    from cvpce_tpu.pipeline import serving as jserving
    from cvpce_tpu_torch.train import gln as gln_train
    from cvpce_tpu_torch.utils.weights import gln_state_dict

    started = []

    def init(*args, state_dict=None, **kwargs):
        started.append(state_dict)
        raise StopIteration  # the start is all this test needs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gln_train, "init_train_state", init)
        with pytest.raises(StopIteration):
            port_cli(["gln", "train", "--imgs", files["sku_imgs"],
                      "--annotations", files["sku_ann"], "--out",
                      str(tmp_path / "run"), "--load", TRAINED["gln"]]
                     + small_args())
    _assert_same_state(started.pop(), gln_state_dict(jax.device_get(
        jserving.load_gln_variables(TRAINED["gln"]))))
