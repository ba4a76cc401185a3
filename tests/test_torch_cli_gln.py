"""The port's command line (cvpce_tpu_torch/cli): its tree and options
against the JAX package's click CLI, and what JAX's commands cannot be
held to against the port's own library on the files of
tests/torch_cli_common.py:
`gln train` followed by `gln eval --weights <out>/epoch_0`, `gln
hyperopt`, `seek-sku110k-outliers` (JAX's fixed 832x1344 config), the
weights loaders on the port's own checkpoints, usage errors, `--device`,
and the drawing commands (matplotlib is installed here). `gln eval` and
`gln build-assistant` are held to JAX's in tests/test_torch_cli_eval.py,
beside the evaluation commands whose JAX models and compiled ops they
share.

Tolerance: everything held to the port's library is equal (the same
code on the same CPU).
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from torch_cli_common import (CANVAS, canvas_args, json_of, small_args,
                              write_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_train_dihe_loops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("cli_gln"), seed=1)


def port_cli(args, device="cpu") -> str:
    from cvpce_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--device", device] + list(args)) == 0
    return out.getvalue()


def sku_eval_args(f):
    return (["gln", "eval", "--imgs", f["sku_imgs"], "--annotations",
             f["sku_ann"], "--weights", f["gln"]] + small_args())


# ------------------------------------------------------ tree and options

def _click_commands():
    """(path, click command) for every command of the JAX CLI, groups
    within groups walked down to their commands."""
    from cvpce_tpu.cli import cli

    out = []

    def walk(path, cmd):
        if hasattr(cmd, "commands"):
            for name, sub in cmd.commands.items():
                walk(path + (name,), sub)
        else:
            out.append((path, cmd))
    walk((), cli)
    return out


def _required_args(path, f):
    """The least each command needs to parse."""
    image = f["demo_scene"]
    required = {
        ("gln", "train"): ["--out", "x"],
        ("gln", "eval"): ["--weights", "w"],
        ("gln", "detect"): [image, "--weights", "w"],
        ("gln", "seek-sku110k-outliers"): ["--weights", "w"],
        ("gln", "hyperopt"): ["--out", "x"],
        ("misc", "pipeline-demo"): [image, "--gallery", f["folder"],
                                    "--planogram", f["demo_plano"]],
        ("misc", "retinanet-coco-test"): ["--imgs", "i", "--annotations",
                                          "a"],
        ("rebuild-scene",): ["--gln-weights", "w", image, "--out", "o"],
        ("plot-planogram-eval",): ["--gln-weights", "w", "--out", "o"],
        ("dihe", "pretrain-gan"): ["--out", "x"],
        ("dihe", "train"): ["--out", "x"],
        ("dihe", "prebuild-index"): ["--out", "x"],
        ("dihe", "visualize-performance"): ["--index", "i", "--out", "o",
                                            image],
        ("dihe", "hyperopt"): ["--out", "x"],
        ("datasets", "gp", "mask-test"): [image, "--out", "o"],
        ("datasets", "gp", "fix"): ["--source", f["folder"], "--out", "x"],
        ("datasets", "internal", "visualize-train"): ["--root", "r",
                                                      "--out", "o"],
        ("datasets", "internal", "visualize"): ["--root", "r", "--out",
                                                "o"],
        ("datasets", "internal", "visualize-planoset"): ["--root", "r",
                                                         "--out", "o"],
        ("datasets", "internal", "iter-train"): ["--root", "r"],
    }
    if path[0] == "datasets" and "visualize" in path[-1]:
        return required.get(path, ["--out", "o"])
    if path[0].startswith("eval-"):
        return ["--gln-weights", "w"]
    return required.get(path, [])


def _port_subparser(path):
    from cvpce_tpu_torch.cli import build_parser

    parser = build_parser()
    for name in path:
        parser = parser._subparsers._group_actions[0].choices[name]
    return parser


def _port_commands():
    """Every command path of the port's parser, groups walked down."""
    from cvpce_tpu_torch.cli import build_parser

    out = set()

    def walk(path, parser):
        if parser._subparsers is None:
            out.add(path)
            return
        for name, sub in parser._subparsers._group_actions[0] \
                .choices.items():
            walk(path + (name,), sub)
    walk((), build_parser())
    return out


def test_command_tree_matches_jax():
    """The whole tree: 40 commands in 8 groups, each path the JAX CLI's,
    and no other."""
    from cvpce_tpu.cli import cli

    paths = {p for p, _ in _click_commands()}
    assert len(paths) == 40
    assert len({p[:-1] for p in paths if len(p) > 1}) == 8
    assert _port_commands() == paths
    assert {p[0] for p in paths} == set(cli.commands)
    text = subprocess.run(
        [sys.executable, "-m", "cvpce_tpu_torch.cli", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120).stdout
    for name in cli.commands:
        assert f"\n    {name}" in text, text


def test_options_and_defaults_match_click(files):
    """Every click parameter has a port option of the same name, flags,
    choices and default: parsing the same minimal command line gives the
    same values on both sides."""
    import click

    from cvpce_tpu_torch.cli import build_parser

    for path, cmd in _click_commands():
        args = _required_args(path, files)
        want = cmd.make_context(" ".join(path), list(args)).params
        ns = vars(build_parser().parse_args(["--device", "cpu", *path,
                                             *args]))
        got = {k: tuple(v) if isinstance(v, list) else v
               for k, v in ns.items()
               if k not in ("_run", "_parser", "command", "group_command",
                            "subgroup_command", "device")}
        assert got == want, path
        sub = _port_subparser(path)
        for param in cmd.params:
            if not isinstance(param, click.Option):
                continue
            for flag in param.opts:
                action = sub._option_string_actions[flag]
                assert action.dest == param.name, (path, flag)
            if isinstance(param.type, click.Choice):
                assert list(action.choices) == list(param.type.choices)
            if param.nargs > 1:
                assert action.nargs == param.nargs, (path, param.name)


def test_multiple_options_append_in_place_of_the_default(files):
    from cvpce_tpu_torch.cli import build_parser

    ns = build_parser().parse_args(
        ["eval-product-detection", "--gln-weights", "w", "--source", "a",
         "--source", "b", "-t", "0.6", "--iou-threshold", "0.7"])
    assert ns.source == ("a", "b")
    assert ns.iou_thresholds == (0.6, 0.7)
    ns = build_parser().parse_args(["gln", "eval", "--weights", "w"])
    assert ns.iou_thresholds == ()


@pytest.mark.parametrize("argv", [
    ["gln", "eval"],                                      # --weights
    ["gln", "eval", "--weights", "w", "--dataset-type", "coco"],
    ["gln", "eval", "--weights", "w", "--canvas", "64"],
    ["gln", "detect", "/no/such/image.png", "--weights", "w"],
    ["gln", "nosuch"],
    ["eval-planograms", "--gln-weights", "w", "--fast", "yes"],
    ["misc"],
    ["dihe"],
    ["datasets", "gp"],
    ["datasets", "gp", "fix", "--source", "/no/such/dir", "--out", "x"],
    ["dihe", "eval", "--only", "train"],
])
def test_usage_errors_exit_2(argv):
    from cvpce_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exit_:
        main(["--device", "cpu"] + argv)
    assert exit_.value.code == 2


def test_the_card_is_required_without_device_cpu():
    from cvpce_tpu_torch.cli import main

    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["gln", "build-assistant"] + canvas_args())


# ------------------------------------------------------------- loaders

def test_loaders_read_the_ports_checkpoints(tmp_path):
    from cvpce_tpu_torch.cli.common import load_embedder, load_gln_state_dict
    from cvpce_tpu_torch.models.embedders import fold_bn_variables
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.train.checkpoint import CheckpointManager
    from cvpce_tpu_torch.train.dihe import DIHETrainConfig, init_dihe_state

    state = init_dihe_state(DIHETrainConfig(gen_downs=4), seed=3,
                            device="cpu")
    CheckpointManager(str(tmp_path), name="embedder_checkpoint") \
        .save_rotating(state, {"epoch": 0})
    encode, size = load_embedder(str(tmp_path / "embedder_checkpoint"),
                                 device="cpu")
    want = fold_bn_variables(state.embedder)
    assert size == want.embedding_size
    got_sd = encode.model.state_dict()
    assert set(got_sd) == set(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got_sd[k], v), k

    config = GLNConfig(canvas_h=CANVAS, canvas_w=CANVAS)
    bad = tmp_path / "bad.pt"
    torch.save({"model": {"body.nosuch": torch.zeros(1)}, "optimizer": {},
                "step": 0}, bad)
    with pytest.raises(RuntimeError, match="body.nosuch"):
        load_gln_state_dict(str(bad), config)  # loaded strictly
    torch.save({"weights": torch.zeros(1), "epoch": 3}, bad)
    with pytest.raises(ValueError, match="'epoch', 'weights'"):
        load_gln_state_dict(str(bad), config)
    with pytest.raises(ValueError, match="'epoch', 'weights'"):
        load_embedder(str(bad), device="cpu")
    # a directory: the DIHE run loads as its checkpoint file does; it is
    # no GLN run, and no orbax node either (no _METADATA): no GLN
    # checkpoint
    encode, _ = load_embedder(str(tmp_path), device="cpu")
    got_sd = encode.model.state_dict()
    for k, v in want.state_dict().items():
        assert torch.equal(got_sd[k], v), k
    with pytest.raises(ValueError, match="not a GLN checkpoint: a directory"):
        load_gln_state_dict(str(tmp_path), config)


# ------------------------------------------------ training and search

def test_train_then_eval_reproduces_the_in_memory_metrics(files, tmp_path):
    """`gln train` writes epoch_0; `gln eval --weights <out>/epoch_0`
    prints the metrics of evaluate_gln on the state the loop returned
    (tests/test_orbax_cli_roundtrip.py's round trip, on the port's
    checkpoint files)."""
    import dataclasses

    from cvpce_tpu_torch.cli.common import (default_gln_config,
                                            load_gln_state_dict)
    from cvpce_tpu_torch.cli.gln import eval_summary, load_eval_dataset
    from cvpce_tpu_torch.eval import evaluate_gln
    from cvpce_tpu_torch.train import loops

    run = tmp_path / "run"
    returned = {}
    train = loops.train_proposal_generator

    def keep(*args, **kwargs):
        returned.update(train(*args, **kwargs))
        return returned

    data = ["--imgs", files["sku_imgs"], "--annotations", files["sku_ann"]]
    try:
        with mock.patch.object(loops, "train_proposal_generator", keep):
            port_cli(["gln", "train", *data, "--out", str(run),
                      "--epochs", "1", "--batch-size", "2"] + small_args())
        weights = str(run / "epoch_0")
        got = port_cli(["gln", "eval", *data, "--weights", weights]
                       + small_args())
        state = returned["state"]
        config = dataclasses.replace(
            default_gln_config(), canvas_h=CANVAS, canvas_w=CANVAS,
            detections_per_img=64, max_nms_candidates=128)
        loaded = load_gln_state_dict(weights, config)
        for k, v in state.model.state_dict().items():
            assert torch.equal(loaded[k], v), k
        res = evaluate_gln(state.model.state_dict(),
                           load_eval_dataset("sku110k", *data[1::2], config,
                                             "cpu"),
                           config, device="cpu")
        assert json_of(got) == eval_summary(res)
        assert state.step == 2
    finally:
        shutil.rmtree(run, ignore_errors=True)


def test_hyperopt_two_trials(files, tmp_path):
    """Two one-epoch trials: each trial's metric is the AP at IoU 0.75
    of its epoch_0 checkpoint (the loop's epoch eval), and the result file
    names the best."""
    from cvpce_tpu_torch.cli.common import load_gln_state_dict
    from cvpce_tpu_torch.cli.gln import load_eval_dataset
    from cvpce_tpu_torch.eval import evaluate_gln
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.train.hyperopt import GLN_SPACE

    out = tmp_path / "search"
    try:
        text = port_cli(["gln", "hyperopt", "--imgs", files["sku_imgs"],
                         "--annotations", files["sku_ann"], "--out",
                         str(out), "--trials", "2", "--max-epochs", "1",
                         "--batch-size", "2"] + canvas_args())
        result = json.loads((out / "hyperopt_result.json").read_text())
        assert json_of(text) == result
        trials = json.loads((out / "search_state.json").read_text())[
            "trials"]
        assert len(trials) == 2
        for t in trials:
            assert not t["failed"] and len(t["results"]) == 1
            assert set(t["config"]) == set(GLN_SPACE)
            config = GLNConfig(tanh=t["config"]["tanh"], canvas_h=CANVAS,
                               canvas_w=CANVAS, max_nms_candidates=64,
                               detections_per_img=64)
            weights = out / f"trial_{t['trial_id'] + 1:03d}" / "epoch_0"
            ap = evaluate_gln(
                load_gln_state_dict(str(weights), config),
                load_eval_dataset("sku110k", files["sku_imgs"],
                                  files["sku_ann"], config, "cpu"),
                config, thresholds=(0.75,), device="cpu")[0.75]["ap"]
            assert t["results"][0] == ap
        best = max(trials, key=lambda t: t["results"][0])
        assert result == {"best_config": best["config"],
                          "best_metric": best["results"][0]}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _seek_loss(outputs, item, config, train_cfg, bucket=None):
    """An item's eval-mode total loss from the model's `outputs` through
    train/gln.py, its boxes padded to `bucket` (as the JAX command pads
    them) or not."""
    from cvpce_tpu_torch.data.sku110k import pad_boxes
    from cvpce_tpu_torch.train.gln import (compute_losses,
                                           render_heatmap_targets)

    n = len(item["boxes"])
    b, v = pad_boxes(item["boxes"], bucket or n)
    boxes, valid = torch.from_numpy(b[None]), torch.from_numpy(v[None])
    sizes = torch.from_numpy(item["image_size"][None])
    with torch.inference_mode():
        heat = render_heatmap_targets(boxes, valid, sizes, config,
                                      train_cfg)[..., None]
        parts = compute_losses(outputs,
                               torch.from_numpy(config.anchors()[0]), boxes,
                               valid, heat, config, train_cfg)
    return float(parts["classification"] + parts["bbox_regression"]
                 + parts["gaussian"])


def test_seek_outliers_matches_the_library(files, tmp_path):
    """Two photos at JAX's fixed 832x1344 GLNConfig(): the GLN sees each
    photo's canvas, and the printed mean, spread, threshold and outliers
    are those of each photo's eval-mode total loss through train/gln.py's
    compute_losses on the GLN's outputs (recorded, so that the 832x1344
    forward runs once a photo)."""
    from cvpce_tpu_torch.data.sku110k import SKU110KDataset
    from cvpce_tpu_torch.models.gln import GLN, GLNConfig
    from cvpce_tpu_torch.train.gln import GLNTrainConfig

    ann = tmp_path / "two.csv"
    rows = open(files["sku_ann"]).read().splitlines()
    ann.write_text("\n".join(r for r in rows
                             if r.split(",")[0] in ("train_0.jpg",
                                                    "train_1.jpg")) + "\n")
    seen, forward = [], GLN.forward

    def recording(model, images):
        outputs = forward(model, images)
        seen.append((images.clone(), {k: v.clone()
                                      for k, v in outputs.items()}))
        return outputs

    with mock.patch.object(GLN, "forward", recording):
        text = port_cli(["gln", "seek-sku110k-outliers", "--imgs",
                         files["sku_imgs"], "--annotations", str(ann),
                         "--weights", files["gln"], "--sigmas", "0.5"])

    config, train_cfg = GLNConfig(), GLNTrainConfig()
    dataset = SKU110KDataset(files["sku_imgs"], str(ann), flip_chance=0.0)
    assert len(seen) == len(dataset) == 2
    losses = []
    for (images, outputs), i in zip(seen, range(len(dataset))):
        item = dataset[i]
        assert torch.equal(images, torch.as_tensor(item["image"])[None])
        losses.append((_seek_loss(outputs, item, config, train_cfg),
                       item["name"]))
    values = np.array([loss for loss, _ in losses])
    thresh = values.mean() + 0.5 * values.std()
    want = ["0/2", f"mean {values.mean():.3f} std {values.std():.3f} "
                   f"threshold {thresh:.3f}"]
    want += [f"  {loss:.3f}\t{n}" for loss, n in sorted(losses, reverse=True)
             if loss > thresh]
    assert text.splitlines() == want
    assert len(want) == 3  # one photo over mean + 0.5 std


def test_padded_boxes_change_no_seek_loss(files):
    """JAX's command pads each photo's boxes to 768 for its jit; the
    port's takes them as they are. The loss is the same, bit for bit
    (checked at 64x64: at 832x1344 the padded matching alone takes
    seconds a photo)."""
    from cvpce_tpu_torch.cli.common import load_gln_state_dict
    from cvpce_tpu_torch.data.sku110k import SKU110KDataset
    from cvpce_tpu_torch.models.gln import GLN, GLNConfig
    from cvpce_tpu_torch.train.gln import GLNTrainConfig

    config, train_cfg = GLNConfig(canvas_h=CANVAS, canvas_w=CANVAS), \
        GLNTrainConfig()
    model = GLN(config)
    model.load_state_dict(load_gln_state_dict(files["gln"], config))
    model.eval()
    dataset = SKU110KDataset(files["sku_imgs"], files["sku_ann"],
                             flip_chance=0.0, canvas_h=CANVAS,
                             canvas_w=CANVAS)
    for i in range(len(dataset)):
        item = dataset[i]
        with torch.inference_mode():
            outputs = model(torch.as_tensor(item["image"])[None])
        assert _seek_loss(outputs, item, config, train_cfg) == \
            _seek_loss(outputs, item, config, train_cfg, bucket=768)


# ------------------------------------------------------------- drawing

def test_drawing_commands_write_their_files(files, tmp_path):
    """rebuild-scene, plot-planogram-eval, detect --out (at its fixed
    832x1344 canvas) and gln eval --plots each save a PNG;
    plot-planogram-eval without --store exits 2 before building
    anything."""
    pipeline = ["--gln-weights", files["gln"], "--encoder-weights",
                files["vgg"], "--source", files["source"], "--confidence",
                "0.0"] + small_args()
    gp = ["--test-imgs", files["test_imgs"], "--test-annotations",
          files["test_ann"], "--planograms", files["planos"]]
    scene = os.path.join(files["test_imgs"], "store1", "images",
                         "store1_1.jpg")
    runs = {
        "rebuild": ["rebuild-scene", *pipeline, scene],
        "plot_gp180": ["plot-planogram-eval", *gp, "--store", "1",
                       "--image", "1", *pipeline],
        "detect": ["gln", "detect", scene, "--weights", files["gln"],
                   "--threshold", "0.1"],
    }
    for name, args in runs.items():
        out = str(tmp_path / f"{name}.png")
        lines = port_cli(args + ["--out", out]).splitlines()
        assert f"saved {out}" in lines[-1] if name == "detect" else \
            lines[0].startswith(f"saved {out}"), lines
        with open(out, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    n = int(lines[0].split()[0])
    assert lines[0] == f"{n} detections over 0.1" and n > 0
    assert len(lines) == 2 + min(n, 20)

    plots = str(tmp_path / "curves.png")
    port_cli(sku_eval_args(files) + ["--plots", plots])
    assert os.path.exists(str(tmp_path / "curves_iou0.5.png"))

    from cvpce_tpu_torch.cli import main

    with mock.patch("cvpce_tpu_torch.cli.eval.build_pipeline") as build:
        with pytest.raises(SystemExit) as exit_:
            main(["--device", "cpu", "plot-planogram-eval", *gp, "--out",
                  plots] + pipeline)
    assert exit_.value.code == 2 and not build.called
