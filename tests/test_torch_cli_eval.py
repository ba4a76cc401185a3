"""The port's evaluation commands (`gln eval`, cvpce_tpu_torch/cli/eval.py,
the `misc` group) and `gln build-assistant` against the JAX package's
click commands on the same files and weights (tests/torch_cli_common.py)
at a 64x64 canvas, on the CPU, all sharing JAX's models: `gln eval` on
SKU-110K and GP-180 layouts, `eval-planograms` on an internal planoset
and on a GP-180 layout, `eval-product-detection`, `misc pipeline-demo`
and `misc retinanet-coco-test`. Then what the JAX package cannot be held
to: `--fast` (bf16 convs and an int8-static embedder in the port, f32 in
JAX's on the CPU) against the port's library on the same options,
`--index` against the gallery built from the folders, `--sharded-gallery`
at world size 1 over gloo, and Classifier(verbose=True).

Tolerances: build-assistant's lines, every metric, count and compliance
are equal; `c` (a score) within 1e-6 (the forward's f32 convolutions sum
in another order than XLA's: 6e-7 measured here). Compliance goes
through RANSAC, whose generators differ between the packages by design
(ROADMAP Queue 3), so the scenes are ones whose compliance does not move
with the RANSAC seed, which a test checks on the port.
"""
import contextlib
import functools
import io
import json
from unittest import mock

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from torch_cli_common import (canvas_args, jax_models_built_once, json_of,
                              small_args, write_inputs)

SCORE_TOL = 1e-6
BUILD_ASSISTANT = ["gln", "build-assistant"] + canvas_args()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_train_dihe_loops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("cli_eval"), seed=1)


def pipeline_args(f, *extra):
    return (["--gln-weights", f["gln"], "--encoder-weights", f["vgg"],
             "--source", f["source"], "--confidence", "0.0"]
            + small_args() + list(extra))


@pytest.fixture(scope="module")
def cmds(files):
    return commands(files)


def commands(f):
    """The commands held against JAX's, by name."""
    gp = ["--test-imgs", f["test_imgs"], "--test-annotations", f["test_ann"]]
    return {
        "gln_eval_sku110k": ["gln", "eval", "--imgs", f["sku_imgs"],
                             "--annotations", f["sku_ann"], "--weights",
                             f["gln"]] + small_args(),
        "gln_eval_gp180": ["gln", "eval", "--dataset-type", "gp180",
                           "--imgs", f["test_imgs"], "--annotations",
                           f["test_ann"], "--weights", f["gln"]]
        + small_args(),
        "planograms_internal": ["eval-planograms", "--internal",
                                f["internal"], "--verbose"]
        + pipeline_args(f),
        "planograms_gp180": ["eval-planograms", *gp, "--planograms",
                             f["planos"], "--verbose"] + pipeline_args(f),
        "product_detection": ["eval-product-detection", *gp]
        + pipeline_args(f),
        "pipeline_demo": ["misc", "pipeline-demo", f["demo_scene"],
                          "--gallery", f["folder"], "--planogram",
                          f["demo_plano"], "--gln-weights", f["gln"],
                          "--encoder-weights", f["vgg"], "--confidence",
                          "0.0"] + canvas_args(),
        "retinanet_coco": ["misc", "retinanet-coco-test", "--imgs",
                           f["sku_imgs"], "--annotations", f["coco_ann"],
                           "--weights", f["gln"]] + canvas_args(),
    }


def port_cli(args) -> str:
    from cvpce_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--device", "cpu"] + list(args)) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def jax_outputs(cmds):
    from cvpce_tpu.cli import cli

    outputs = {}
    with jax_models_built_once():
        for name, args in cmds.items():
            res = CliRunner().invoke(cli, args, catch_exceptions=False)
            assert res.exit_code == 0, res.output
            outputs[name] = json_of(res.output)
    res = CliRunner().invoke(cli, BUILD_ASSISTANT, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    outputs["build_assistant"] = res.output
    return outputs


@pytest.fixture(scope="module")
def port_outputs(cmds):
    """Each command's JSON through the port, run once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = json_of(port_cli(cmds[name]))
        return cache[name]
    return get


def assert_same(got, want, key=""):
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            assert_same(got[k], want[k], k)
    elif isinstance(want, list):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            assert_same(g, w, key)
    elif key == "c":
        assert abs(got - want) <= SCORE_TOL, (key, got, want)
    else:
        assert got == want, (key, got, want)


@pytest.mark.parametrize("name", ["gln_eval_sku110k", "gln_eval_gp180",
                                  "planograms_internal", "planograms_gp180",
                                  "product_detection", "pipeline_demo",
                                  "retinanet_coco"])
def test_command_matches_jax(name, jax_outputs, port_outputs):
    assert_same(port_outputs(name), jax_outputs[name])


def test_build_assistant_matches_jax(jax_outputs):
    """gln build-assistant's lines (shapes in JAX's NHWC order)."""
    assert port_cli(BUILD_ASSISTANT) == jax_outputs["build_assistant"]


def test_outputs_are_not_trivial(jax_outputs):
    """Detections are found and matched, and compliance is neither 0 nor
    1 somewhere."""
    sku = jax_outputs["gln_eval_sku110k"]["0.5"]
    assert sku["ap"] > 0 and 0 < sku["r"] < 1
    coco = jax_outputs["retinanet_coco"]
    assert coco["reference_protocol"]["0.5"]["ap"] > 0
    assert coco["coco_protocol"]["ap50"] > 0
    assert jax_outputs["product_detection"]["overall"]["0.5"]["c"] > 0
    scores = (jax_outputs["planograms_internal"]["per_image"]
              + jax_outputs["planograms_gp180"]["per_image"]
              + [jax_outputs["pipeline_demo"]["compliance"]])
    assert any(0 < s < 1 for s in scores), scores


def test_compliance_does_not_depend_on_the_ransac_seed(cmds, port_outputs):
    from cvpce_tpu_torch.pipeline import evaluator

    reseeded = functools.partial(evaluator.pg.finalize_via_ransac, seed=7)
    with mock.patch.object(evaluator.pg, "finalize_via_ransac", reseeded):
        got = json_of(port_cli(cmds["planograms_internal"]))
    assert got == port_outputs("planograms_internal")


def fast_pipeline(f):
    """eval-planograms --fast's generator and classifier through the
    port's library calls."""
    import dataclasses

    from cvpce_tpu_torch.cli.common import (default_gln_config,
                                            load_embedder,
                                            load_gln_state_dict)
    from cvpce_tpu_torch.data.grocery import GroceryProductsDataset
    from cvpce_tpu_torch.pipeline.classifier import Classifier
    from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator

    config = dataclasses.replace(default_gln_config(True), canvas_h=64,
                                 canvas_w=64, detections_per_img=64,
                                 max_nms_candidates=128)
    generator = ProposalGenerator(load_gln_state_dict(f["gln"], config),
                                  config, confidence_threshold=0.0,
                                  device="cpu")
    encoder, size = load_embedder(f["vgg"], int8=True, device="cpu")
    gallery = GroceryProductsDataset([f["source"]], random_crop=False,
                                     include_annotations=True)
    return generator, Classifier(encoder, size, gallery, device="cpu")


def test_fast_matches_the_library(files, cmds):
    """--fast: bf16 GLN convs and the int8-static embedder, calibrated on
    the gallery, as default_gln_config(True) and load_embedder(int8=True)
    serve them."""
    from cvpce_tpu_torch.data.planograms import InternalPlanoSet
    from cvpce_tpu_torch.eval import evaluate_planograms
    from cvpce_tpu_torch.pipeline.evaluator import (PlanogramComparator,
                                                    PlanogramEvaluator)

    got = json_of(port_cli(cmds["planograms_internal"] + ["--fast"]))
    evaluator = PlanogramEvaluator(*fast_pipeline(files),
                                   PlanogramComparator(device="cpu"))
    assert got == evaluate_planograms(evaluator,
                                      InternalPlanoSet(files["internal"]))


def test_index_and_sharded_gallery_match_the_folders(files, cmds,
                                                     port_outputs, tmp_path):
    """--index reads what Classifier.save_index wrote, and
    --sharded-gallery (one gloo rank, started and ended by the command)
    searches the same gallery: both give the folders' result."""
    import torch.distributed as dist

    from cvpce_tpu_torch.cli.common import load_embedder
    from cvpce_tpu_torch.data.grocery import GroceryProductsDataset
    from cvpce_tpu_torch.pipeline.classifier import Classifier

    index = str(tmp_path / "index.npz")
    encoder, size = load_embedder(files["vgg"], device="cpu")
    Classifier(encoder, size, GroceryProductsDataset(
        [files["source"]], random_crop=False, include_annotations=True),
        device="cpu").save_index(index)
    want = port_outputs("planograms_internal")
    assert json_of(port_cli(cmds["planograms_internal"]
                            + ["--index", index])) == want
    assert json_of(port_cli(cmds["planograms_internal"]
                            + ["--sharded-gallery"])) == want
    assert not dist.is_initialized()


def test_classifier_verbose_prints_progress_and_keeps_the_index(capsys):
    from cvpce_tpu_torch.pipeline.classifier import Classifier

    rng = np.random.default_rng(3)
    items = [(torch.tensor(rng.uniform(-1, 1, (256, 256, 3)),
                           dtype=torch.float32), None, f"c{i}", f"a{i}")
             for i in range(5)]

    def encode(x):
        return torch.as_tensor(x).mean((1, 2))

    quiet = Classifier(encode, 3, items, batch_size=2, device="cpu")
    capsys.readouterr()
    loud = Classifier(encode, 3, items, batch_size=2, verbose=True,
                      device="cpu")
    assert capsys.readouterr().out == "0\n"
    np.testing.assert_array_equal(loud.embedding, quiet.embedding)
    assert loud.annotations == quiet.annotations


def test_json_helper_reads_after_progress_lines():
    assert json_of('x\n[1/2] y\n{\n "a": 1\n}\n') == {"a": 1}
    assert json_of(json.dumps({"b": 2})) == {"b": 2}
