"""The port's `dihe` commands (cvpce_tpu_torch/cli/dihe.py) on the files
of tests/torch_cli_common.py, on the CPU.

Held to the JAX package's click commands on the same files and weights
(one module-scoped run of JAX's commands, sharing its embedders and
gallery indexes): `eval` (the folders' gallery, `--only val`, `--only
test`, `--validation`, `--encoder resnet50`), `prebuild-index` followed
by `eval --index`, and `visualize-performance`, whose PNG is
pixel-equal to JAX's. The gallery lacks one of the scene's products, so
that some crops are classified wrongly. `eval --int8` is held to the
port's library (load_embedder(int8=True) and eval_dihe), as
tests/test_torch_cli_eval.py holds `--fast`: JAX's int8 MACVGG took 142
s to compile and run on a CPU, more than the rest of the file.
The wiring of `train` and `pretrain-gan` (resume, loader, source type,
`--only`, `--eval-data`, `--gan`, `--imagenet`, `--hyperopt-params`) as
tests/test_cli_dihe_train_wiring.py holds JAX's.
Held to the port's own library calls at 64x64 (gen_downs 4, batch 2):
`pretrain-gan`, `train --gan` and `hyperopt`, whose training the JAX
loops are held to in tests/test_torch_train_dihe_loops.py; and
`--sharded-gallery` (one gloo rank) to the folders' result.

Tolerances: printed JSON and text are equal; the two packages' gallery
indexes agree within 1e-5 of the embeddings' largest magnitude (f32
convolutions summed in another order; 1e-6 measured); the PNG is equal
pixel for pixel (the images drawn are equal arrays: the queries are
256x256 already, so both resizes are the identity).
"""
import contextlib
import functools
import io
import json
import os
import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.testing import write_png
from torch_cli_common import json_of, write_inputs

S = 64  # the library-held training runs' image size
GEN_DOWNS = 4
INDEX_TOL = 1e-5


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
    f = write_inputs(tmp_path_factory.mktemp("cli_dihe"), seed=1)
    root = Path(f["root"])
    # the gallery without Drinks/Juice/1, which the scene shows once
    shutil.copytree(Path(f["source"]) / "Food", root / "gallery3" / "Food")
    f["gallery3"] = str(root / "gallery3")
    torch.save(testing.resnet50_state_dict(np.random.default_rng(5)),
               root / "resnet.pth")
    f["resnet"] = str(root / "resnet.pth")
    # visualize-performance's queries: two gallery products on a white
    # 256x256 square
    gallery = sorted(Path(f["gallery3"]).rglob("*.jpg"))
    queries = []
    for k, src in enumerate(gallery[:2]):
        from cvpce_tpu_torch.data.transforms import load_image

        img = np.full((256, 256, 3), 255, np.uint8)
        product = (load_image(str(src)) * 255).round().astype(np.uint8)
        h, w = product.shape[:2]
        img[100:100 + h, 110:110 + w] = product
        queries.append(str(root / f"query{k}.png"))
        write_png(queries[-1], img)
    f["queries"] = queries
    yield f
    shutil.rmtree(root, ignore_errors=True)


def port_cli(args) -> str:
    from cvpce_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--device", "cpu"] + list(args)) == 0
    return out.getvalue()


def eval_args(f, *extra, weights=None):
    return ["dihe", "eval", "--source", f["gallery3"], "--test-imgs",
            f["test_imgs"], "--test-annotations", f["test_ann"],
            "--weights", weights or f["vgg"], "--batch-size", "8",
            "--k", "1", "--k", "3", *extra]


def commands(f, out_dir, index):
    """The commands held against JAX's, by name; `out_dir` takes the
    files they write, `index` is the prebuilt index to read."""
    return {
        "eval": eval_args(f),
        "eval_val": eval_args(f, "--only", "val"),
        "eval_test": eval_args(f, "--only", "test"),
        "eval_validation": eval_args(f, "--validation"),
        "eval_resnet50": eval_args(f, "--encoder", "resnet50",
                                   "--resnet-layers", "2",
                                   "--resnet-layers", "3",
                                   weights=f["resnet"]),
        "prebuild_index": ["dihe", "prebuild-index", "--source",
                           f["gallery3"], "--weights", f["vgg"], "--out",
                           str(out_dir / "index.npz"), "--batch-size", "8"],
        "eval_index": eval_args(f, "--index", index),
        "visualize_performance": ["dihe", "visualize-performance",
                                  "--index", index, "--weights", f["vgg"],
                                  *f["queries"], "--out",
                                  str(out_dir / "knn.png"), "--k", "3"],
    }


@contextlib.contextmanager
def jax_embedders_built_once():
    """JAX's dihe commands share one embedder per (weights, encoder,
    int8, layers) and one gallery index per (embedder, gallery files):
    each is a pure function of those."""
    from cvpce_tpu.cli import common, dihe as j_dihe
    from cvpce_tpu.pipeline.classifier import Classifier

    @functools.lru_cache(maxsize=None)
    def embedder_of(weights, encoder, int8, layers):
        return common.load_embedder(weights, encoder=encoder, int8=int8,
                                    resnet_layers=layers)

    def embedder(weights, encoder="vgg16", int8=False, resnet_layers=(2, 3)):
        return embedder_of(weights, encoder, int8, tuple(resnet_layers))

    build_index, indexes = Classifier.build_index, {}

    def index_once(self, sample_set, verbose=False):
        key = (id(self.encoder_fn), tuple(sample_set.paths), verbose)
        if key not in indexes:
            indexes[key] = build_index(self, sample_set, verbose)
        return indexes[key]

    with mock.patch.object(j_dihe, "load_embedder", embedder), \
            mock.patch.object(Classifier, "build_index", index_once):
        yield


@pytest.fixture(scope="module")
def jax_run(files, tmp_path_factory):
    """Each JAX command's output, its prebuilt index eval-ed and drawn
    on; run once."""
    from cvpce_tpu.cli import cli

    out_dir = tmp_path_factory.mktemp("jax_dihe")
    cmds = commands(files, out_dir, str(out_dir / "index.npz"))
    outputs = {}
    with jax_embedders_built_once():
        for name, args in cmds.items():  # prebuild-index before its use
            res = CliRunner().invoke(cli, args, catch_exceptions=False)
            assert res.exit_code == 0, res.output
            outputs[name] = res.output
    return outputs, out_dir


@pytest.fixture(scope="module")
def port_run(files, tmp_path_factory):
    """Each port command's output, run once on first use."""
    out_dir = tmp_path_factory.mktemp("port_dihe")
    cmds = commands(files, out_dir, str(out_dir / "index.npz"))
    cache = {}

    def get(name):
        if name == "eval_index" or name == "visualize_performance":
            get("prebuild_index")
        if name not in cache:
            cache[name] = port_cli(cmds[name])
        return cache[name]
    return get, out_dir


@pytest.mark.parametrize("name", ["eval", "eval_val", "eval_test",
                                  "eval_validation", "eval_resnet50",
                                  "eval_index"])
def test_eval_matches_jax(name, jax_run, port_run):
    want = json_of(jax_run[0][name])
    assert json_of(port_run[0](name)) == want
    assert set(want) == {"1", "3"}


def test_eval_is_not_trivial(jax_run):
    """The splits differ, and some crops are right, some wrong: the
    missing product's crop is among the test split's."""
    outs = {n: json_of(t) for n, t in jax_run[0].items()
            if n.startswith("eval")}
    assert outs["eval_val"] == outs["eval_validation"]
    assert outs["eval"]["1"] == outs["eval_index"]["1"] == 5 / 6, outs
    assert outs["eval_test"]["1"] < outs["eval_val"]["1"], outs


def test_eval_int8_matches_the_library(files):
    """--int8: the static int8 embedder in bf16, calibrated on the
    gallery, as load_embedder(int8=True) and eval_dihe serve it."""
    from cvpce_tpu_torch.cli.common import load_embedder
    from cvpce_tpu_torch.data.grocery import (GroceryProductsDataset,
                                              GroceryProductsTestSet)
    from cvpce_tpu_torch.eval.classification import eval_dihe

    got = json_of(port_cli(eval_args(files, "--int8")))
    encoder, size = load_embedder(files["vgg"], int8=True, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        want = eval_dihe(encoder, size, GroceryProductsDataset(
            [files["gallery3"]], random_crop=False,
            include_annotations=True), GroceryProductsTestSet(
                files["test_imgs"], files["test_ann"]), batch_size=8,
            k=(1, 3), device="cpu")
    assert got == {str(k): v for k, v in want.items()}
    assert got["1"] > 0


def test_prebuild_index_matches_jax(jax_run, port_run):
    """The printed lines (Classifier(verbose=True)'s progress, then the
    entry count) and the index: annotations equal, embeddings within
    INDEX_TOL of their largest magnitude."""
    (jax_out, jax_dir), (port, port_dir) = jax_run, port_run
    text = port("prebuild_index")
    assert text == jax_out["prebuild_index"].replace(
        str(jax_dir), str(port_dir))
    assert text.endswith(f"index with 3 entries -> "
                         f"{port_dir / 'index.npz'}\n")
    got, want = (np.load(d / "index.npz", allow_pickle=True)
                 for d in (port_dir, jax_dir))
    assert list(got["annotations"]) == list(want["annotations"])
    scale = np.abs(want["embedding"]).max()
    np.testing.assert_allclose(got["embedding"], want["embedding"],
                               rtol=0, atol=INDEX_TOL * scale)


def test_visualize_performance_is_pixel_equal(jax_run, port_run):
    import matplotlib.image

    (jax_out, jax_dir), (port, port_dir) = jax_run, port_run
    text = port("visualize_performance")
    assert text == f"saved {port_dir / 'knn.png'}\n"
    np.testing.assert_array_equal(
        matplotlib.image.imread(str(port_dir / "knn.png")),
        matplotlib.image.imread(str(jax_dir / "knn.png")))


def test_visualize_performance_needs_matplotlib_first(files, tmp_path):
    """Without matplotlib (the card's machine) it fails naming it before
    the embedder is built."""
    from cvpce_tpu_torch.cli import dihe
    from cvpce_tpu_torch.utils import viz

    with mock.patch.object(viz, "available", lambda: False), \
            mock.patch.object(dihe, "load_embedder") as load:
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            port_cli(["dihe", "visualize-performance", "--index", "i",
                      "--out", str(tmp_path / "o.png"), files["queries"][0]])
    assert not load.called


def test_sharded_gallery_matches_the_folders(files, port_run):
    import torch.distributed as dist

    got = json_of(port_cli(eval_args(files, "--sharded-gallery")))
    assert got == json_of(port_run[0]("eval"))
    assert not dist.is_initialized()


# --------------------------------------------------------------- wiring

class _FakeSet:
    def __init__(self, *args, only=None, **kwargs):
        self.args, self.only, self.kwargs = args, only, kwargs

    def __len__(self):
        return 0


@pytest.fixture
def fake_data(monkeypatch):
    from cvpce_tpu_torch.data import grocery, sku110k

    for mod, name in ((grocery, "GroceryProductsDataset"),
                      (grocery, "GroceryProductsTestSet"),
                      (grocery, "InternalTrainSet"),
                      (sku110k, "TargetDomainDataset")):
        monkeypatch.setattr(mod, name, type(name, (_FakeSet,), {}))


def _recording(monkeypatch, fn_name):
    from cvpce_tpu_torch.train import loops

    calls = []

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return {"state": None, "best": {}}
    monkeypatch.setattr(loops, fn_name, fake)
    return calls


def test_train_passes_resume_loader_and_config(fake_data, monkeypatch,
                                               tmp_path):
    """--resume and --grain reach train_dihe (JAX's wiring test); the
    config is the reference's or, with --hyperopt-params, the preset."""
    from cvpce_tpu_torch.data.grain_loader import GrainLoader
    from cvpce_tpu_torch.train.dihe import DIHETrainConfig

    calls = _recording(monkeypatch, "train_dihe")
    base = ["dihe", "train", "--source", str(tmp_path), "--imgs",
            str(tmp_path), "--annotations", str(tmp_path), "--out",
            str(tmp_path / "run")]
    port_cli(base + ["--epochs", "1", "--resume", "--grain"])
    args, kw = calls.pop()
    assert kw["resume"] is True and kw["loader_cls"] is GrainLoader
    assert args[4] == str(tmp_path / "run") and kw["device"].type == "cpu"
    assert kw["train_cfg"] == DIHETrainConfig()
    assert kw["gan_state"] is None and "init_embedder" not in kw
    port_cli(base + ["--hyperopt-params", "--no-batchnorm", "--masks",
                     "--epochs", "3", "--batch-size", "6"])
    args, kw = calls.pop()
    assert kw["resume"] is False and "loader_cls" not in kw
    assert kw["train_cfg"] == DIHETrainConfig(
        enc_lr=8e-7, enc_multiplier=0.9, batchnorm=False, masks=True)
    assert (kw["epochs"], kw["batch_size"]) == (3, 6)
    assert args[0].kwargs["include_masks"] is True


def test_train_source_type_and_only(fake_data, monkeypatch, tmp_path):
    """--source-type internal routes to InternalTrainSet; --only filters
    the gp gallery and --eval-data gives a separate eval gallery
    (cvpce/cli/dihe.py:85-87,141-145)."""
    from cvpce_tpu_torch.data import grocery

    calls = _recording(monkeypatch, "train_dihe")
    base = ["dihe", "train", "--imgs", str(tmp_path), "--annotations",
            str(tmp_path), "--out", str(tmp_path / "o")]
    port_cli(base + ["--source", str(tmp_path), "--only", "Food", "--only",
                     "Drinks"])
    (dataset, _, evaldata, evalset, _), _ = calls.pop()
    assert isinstance(dataset, grocery.GroceryProductsDataset)
    assert dataset.only == ["Food", "Drinks"] and evaldata is dataset
    assert evalset.only == 2  # the validation split
    port_cli(base + ["--source", "a", "--source", "b", "--source-type",
                     "internal", "--eval-data", "e"])
    (dataset, _, evaldata, _, _), _ = calls.pop()
    assert isinstance(dataset, grocery.InternalTrainSet)
    assert dataset.args == ("a",)
    assert isinstance(evaldata, grocery.GroceryProductsDataset)
    assert evaldata.args == (["e"],)


def test_train_gan_and_imagenet(files, fake_data, monkeypatch, tmp_path):
    """--gan reads the pretrain-gan directory's gan_checkpoint as a
    state_dict; --imagenet lays a vgg16_bn import over the embedder."""
    from cvpce_tpu_torch.train.checkpoint import CheckpointManager
    from cvpce_tpu_torch.train.dihe import (GANPretrainConfig,
                                            make_gan_pretrain_step)
    from cvpce_tpu_torch.utils.torch_import import (import_vgg16_features,
                                                    load_state_dict)

    init, _ = make_gan_pretrain_step(GANPretrainConfig(gen_downs=GEN_DOWNS))
    gan = init(0, gen_channels=3, device="cpu")
    CheckpointManager(str(tmp_path / "gan"), name="gan_checkpoint") \
        .save_rotating(gan, {"epoch": 0})
    calls = _recording(monkeypatch, "train_dihe")
    port_cli(["dihe", "train", "--source", str(tmp_path), "--imgs",
              str(tmp_path), "--annotations", str(tmp_path), "--out",
              str(tmp_path / "o"), "--gan", str(tmp_path / "gan"),
              "--imagenet", files["vgg"]])
    _, kw = calls.pop()
    want = gan.state_dict()
    # the players of the orbax gan_checkpoint (cli/dihe.py:load_gan_state;
    # train_dihe starts their optimizers afresh)
    assert set(kw["gan_state"]) == {"generator", "discriminator"}
    for player in ("generator", "discriminator"):
        for k, v in want[player].items():
            assert torch.equal(kw["gan_state"][player][k], v), k
    want = import_vgg16_features(load_state_dict(files["vgg"]), True)
    assert set(kw["init_embedder"]) == set(want)
    for k, v in want.items():
        assert torch.equal(kw["init_embedder"][k], v), k


def test_pretrain_gan_wiring(fake_data, monkeypatch, tmp_path):
    calls = _recording(monkeypatch, "pretrain_gan")
    port_cli(["dihe", "pretrain-gan", "--source", "a", "--imgs", "i",
              "--annotations", "n", "--out", str(tmp_path / "g"),
              "--epochs", "2", "--batch-size", "3", "--masks", "--resume"])
    (dataset, discset, out), kw = calls.pop()
    assert dataset.args == (["a"],) and dataset.kwargs == {
        "include_masks": True}
    assert discset.args == ("i", "n")
    assert out == str(tmp_path / "g")
    assert {k: kw[k] for k in ("epochs", "batch_size", "masks",
                               "resume")} == {"epochs": 2, "batch_size": 3,
                                              "masks": True, "resume": True}


# ------------------------------------- training held to the library

@contextlib.contextmanager
def at_64():
    """Gallery items, discriminator crops and eval crops at S x S, and
    U-Nets of GEN_DOWNS levels, in the commands and the library alike;
    the loader on one thread, since the gallery's random crops draw from
    one rng in the order the pool's threads fetch the items."""
    from cvpce_tpu_torch.data import transforms as T
    from cvpce_tpu_torch.data.loader import PrefetchLoader
    from cvpce_tpu_torch.eval import classification
    from cvpce_tpu_torch.train import dihe as pdihe
    from cvpce_tpu_torch.train import loops

    patches = (
        (T, "aspect_resize_pad", dict(size=S)),
        (T, "resize_for_classification", dict(size=S)),
        (classification, "crop_resize_square", dict(out_size=S)),
        (pdihe, "DIHETrainConfig", dict(gen_downs=GEN_DOWNS)),
        (loops, "GANPretrainConfig", dict(gen_downs=GEN_DOWNS)))
    with contextlib.ExitStack() as stack:
        for mod, name, kw in patches:
            stack.enter_context(mock.patch.object(
                mod, name, functools.partial(getattr(mod, name), **kw)))
        stack.enter_context(mock.patch.object(
            PrefetchLoader, "__init__", functools.partialmethod(
                PrefetchLoader.__init__, num_threads=1)))
        yield


def _same_tree(a, b, key=""):
    if isinstance(b, dict):
        assert set(a) == set(b), key
        for k in b:
            _same_tree(a[k], b[k], f"{key}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), key
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{key}.{i}")
    elif torch.is_tensor(b):
        assert torch.equal(a, b), key
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key
    else:
        assert a == b, key


def _node(path):
    """A run's orbax checkpoint node, as the port's reader gives it."""
    from cvpce_tpu_torch.utils import orbax_read

    return orbax_read.restore(str(path))


def _library(fn) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def _sets(f):
    from cvpce_tpu_torch.data import defaults
    from cvpce_tpu_torch.data.grocery import (GroceryProductsDataset,
                                              GroceryProductsTestSet)
    from cvpce_tpu_torch.data.sku110k import TargetDomainDataset

    return (GroceryProductsDataset([f["source"]], include_annotations=True),
            TargetDomainDataset(f["sku_imgs"], f["sku_ann"],
                                skip=defaults.SKU110K_SKIP),
            GroceryProductsTestSet(f["test_imgs"], f["test_ann"], only=2))


@pytest.fixture(scope="module")
def gan_dir(files, tmp_path_factory):
    """`dihe pretrain-gan` at S x S, and the same library call."""
    from cvpce_tpu_torch.data.grocery import GroceryProductsDataset
    from cvpce_tpu_torch.train import loops

    root = tmp_path_factory.mktemp("gan")
    with at_64():
        text = port_cli(["dihe", "pretrain-gan", "--source", files["source"],
                         "--imgs", files["sku_imgs"], "--annotations",
                         files["sku_ann"], "--out", str(root / "cli"),
                         "--epochs", "1", "--batch-size", "2"])
        _, discset, _ = _sets(files)
        want = _library(lambda: loops.pretrain_gan(
            GroceryProductsDataset([files["source"]]), discset,
            str(root / "lib"), epochs=1, batch_size=2, device="cpu"))
    yield root, text, want
    shutil.rmtree(root, ignore_errors=True)


def test_pretrain_gan_matches_the_library(gan_dir):
    root, text, want = gan_dir
    assert text == want and "batch:0" in text
    for name in ("gan_checkpoint", "gan_checkpoint.meta.json"):
        assert sorted(os.listdir(root / "cli")) == \
            sorted(os.listdir(root / "lib"))
    _same_tree(_node(root / "cli" / "gan_checkpoint"),
               _node(root / "lib" / "gan_checkpoint"))


def test_train_from_the_gan_matches_the_library(files, gan_dir, tmp_path):
    """`dihe train --gan <pretrain-gan out>`: the same printed lines,
    checkpoint nodes and states as train_dihe given that gan_checkpoint's
    players (cli/dihe.py:load_gan_state)."""
    from cvpce_tpu_torch.cli.dihe import load_gan_state
    from cvpce_tpu_torch.train import loops
    from cvpce_tpu_torch.train.dihe import DIHETrainConfig

    gan = str(gan_dir[0] / "cli")
    with at_64():
        text = port_cli(["dihe", "train", "--source", files["source"],
                         "--imgs", files["sku_imgs"], "--annotations",
                         files["sku_ann"], "--test-imgs", files["test_imgs"],
                         "--test-annotations", files["test_ann"], "--out",
                         str(tmp_path / "cli"), "--gan", gan, "--epochs",
                         "1", "--batch-size", "2"])
        dataset, discset, evalset = _sets(files)
        cfg = DIHETrainConfig(gen_downs=GEN_DOWNS)
        want = _library(lambda: loops.train_dihe(
            dataset, discset, dataset, evalset, str(tmp_path / "lib"),
            gan_state=load_gan_state(gan),
            epochs=1, batch_size=2, train_cfg=cfg, device="cpu"))
    assert text == want and "epoch 0: top-1 accuracy" in text
    names = sorted(os.listdir(tmp_path / "cli"))
    assert names == sorted(os.listdir(tmp_path / "lib"))
    assert "epoch_0" in names and "embedder_checkpoint" in names
    for name in ("embedder_checkpoint", "epoch_0"):
        _same_tree(_node(tmp_path / "cli" / name),
                   _node(tmp_path / "lib" / name))
    # the generator started from the GAN's
    gan_gen = _node(Path(gan) / "gan_checkpoint")["gen_params"]
    trained = _node(tmp_path / "cli" / "embedder_checkpoint")
    assert set(trained["gen_params"]) == set(gan_gen)


def test_hyperopt_two_trials(files, tmp_path):
    """Two one-epoch trials: each trial's metric is the top-1 accuracy of
    eval_dihe on its epoch_0 embedder (the loop's epoch eval, gallery the
    training set, queries the validation split), and the result file
    names the best."""
    from cvpce_tpu_torch.eval.classification import eval_dihe
    from cvpce_tpu_torch.models.embedders import EmbedFn, MACVGG
    from cvpce_tpu_torch.train.hyperopt import DIHE_SPACE
    from cvpce_tpu_torch.utils.weights import macvgg_state_dict

    out = tmp_path / "search"
    with at_64():
        text = port_cli(["dihe", "hyperopt", "--source", files["source"],
                         "--imgs", files["sku_imgs"], "--annotations",
                         files["sku_ann"], "--test-imgs", files["test_imgs"],
                         "--test-annotations", files["test_ann"], "--out",
                         str(out), "--trials", "2", "--max-epochs", "1",
                         "--batch-size", "2"])
        result = json.loads((out / "hyperopt_result.json").read_text())
        assert json_of(text) == result
        trials = json.loads((out / "search_state.json").read_text())[
            "trials"]
        assert len(trials) == 2
        dataset, _, evalset = _sets(files)
        for t in trials:
            assert not t["failed"] and len(t["results"]) == 1
            assert set(t["config"]) == set(DIHE_SPACE)
            weights = out / f"trial_{t['trial_id'] + 1:03d}" / "epoch_0"
            model = MACVGG(batch_norm=t["config"]["batchnorm"])
            node = _node(weights)
            model.load_state_dict(macvgg_state_dict(node["emb_params"],
                                                    node["emb_stats"]))
            acc = eval_dihe(EmbedFn(model, device="cpu"),
                            MACVGG.embedding_size, dataset, evalset,
                            batch_size=2, k=(1,), verbose=False,
                            device="cpu")
            assert t["results"][0] == acc[1]
    best = max(trials, key=lambda t: t["results"][0])
    assert result == {"best_config": best["config"],
                      "best_metric": best["results"][0]}
