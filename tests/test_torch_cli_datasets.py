"""The port's `datasets` commands (cvpce_tpu_torch/cli/datasets.py), all
22, against the JAX package's click commands on the same files (those of
tests/torch_cli_common.py, plus a GroZi-120 layout, an internal trainset
of RGBA products, a GP baseline CSV and a renamed GP download), on the
CPU, with one module-scoped run of JAX's commands.

Printed text is equal. The PNGs are equal pixel for pixel where the
arrays drawn are equal (decoded files, boxes, labels, masks). Six
drawings show what a resize or a renderer made, the port's against
cv2's or XLA's: `sku110k visualize --model` (detections within 1.8e-4
px, ROADMAP.md Queue 3), the `--gaussians` heatmaps of `sku110k
visualize` and `visualize-coco`, `visualize-discriminator-target`, `gp
visualize-train` and `internal visualize-train` (the port's resize,
within 5e-5 of cv2's, ROADMAP.md Queue 3). The reader tests hold those
arrays within their bounds; this file holds their PNGs within PNG_TOL
(1 of 255 a channel) on at most PNG_SHARE of the channel values.
Measured on these fixtures: the discriminator target differs by 1/255
on 1.6e-6 of its values and internal visualize-train on 8.1e-6; the
other four are equal.

`grozi extract-test-images` writes the frames the JAX command writes,
and every drawing command fails naming matplotlib before it reads
anything where matplotlib is missing (the card's machine).
"""
import contextlib
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
from torch_cli_common import (CANVAS, MAX_DETECTIONS, NMS_CANDIDATES,
                              write_inputs)

GROZI_PRODUCTS = 120
# the drawings of a resize's or renderer's output (module docstring):
# channel values within PNG_TOL, and differing on at most PNG_SHARE of
# them
PNG_TOL = 1 / 255 + 1e-6
PNG_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_train_dihe_loops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rgba_product(rng, h, w):
    img = np.zeros((h, w, 4), np.uint8)
    img[2:-2, 3:-3, :3] = rng.integers(0, 255, (h - 4, w - 6, 3))
    img[2:-2, 3:-3, 3] = 255
    return img


def _extra_inputs(f, rng):
    """GroZi-120, internal products, a GP baseline CSV and a GP download
    renamed to food_<n>.jpg, beside the shared files."""
    root = Path(f["root"])
    grozi = root / "grozi"
    frames = grozi / "extracted"
    frames.mkdir(parents=True)
    for p in range(1, GROZI_PRODUCTS + 1):
        web = grozi / "inVitro" / str(p) / "web" / "JPEG"
        web.mkdir(parents=True)
        for k in range(1 + (p % 2)):
            write_png(web / f"web{k}.jpg",
                      rng.integers(0, 255, (12, 10, 3)).astype(np.uint8))
        (grozi / "inSitu" / str(p)).mkdir(parents=True)
    coords = {}
    names = []
    for video, frame, products in ((1, 10, (1, 2, 3)), (1, 20, (2,)),
                                   (2, 5, (4, 5))):
        name = f"{video}_{frame}.jpg"
        names.append(name)
        write_png(frames / name,
                  rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
        for j, p in enumerate(products):
            coords.setdefault(p, []).append(
                f"{video}\t{frame}\t{4 + 12 * j}\t{6 + j}\t10\t14")
    for p in range(1, GROZI_PRODUCTS + 1):
        (grozi / "inSitu" / str(p) / "coordinates.txt").write_text(
            "".join(line + "\n" for line in coords.get(p, [])))
    (frames / "index.txt").write_text("".join(n + "\n" for n in names))
    f["grozi"] = str(grozi)

    # internal trainset: RGBA products, front and back faces; the same
    # folder serves as the planoset's ConvertedProducts
    products = Path(f["internal"]) / "ConvertedProducts"
    for code in ("1001", "1002", "2001"):
        for face in ("front", "back"):
            d = products / "Shelf" / code[0] / face
            d.mkdir(parents=True, exist_ok=True)
            write_png(d / f"{code}.png", _rgba_product(rng, 30, 22))
    f["internal_products"] = str(products)

    # GP baseline: the test scene's annotated boxes
    rows = ["image,x1,y1,x2,y2,label"]
    for line in Path(f["test_ann"], "s1_1.csv").read_text().splitlines():
        label, *box = [v.strip() for v in line.split(",")]
        rows.append(",".join(["store1_1.jpg", *box, label]))
    (root / "baseline.csv").write_text("\n".join(rows) + "\n")
    f["baseline"] = str(root / "baseline.csv")

    # a download whose files were renamed: food_<n>.jpg, the first of
    # each directory a duplicate
    renamed = root / "renamed"
    for cat, n in (("Food/Bakery", 4), ("Food/Dairy", 3), ("Drinks", 2)):
        d = renamed / cat
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"food_{i + 1}.jpg").write_bytes(f"{cat}{i}".encode())
    (renamed / "Food" / "notes.txt").write_text("x")
    f["renamed"] = str(renamed)

    # planogram-test: one more planogram that does not parse
    bad = root / "planos_bad"
    shutil.copytree(f["planos"], bad)
    (bad / "s9_9.json").write_text(json.dumps({"graph": [{"ogg": 0}]}))
    (bad / "readme.txt").write_text("x")
    f["planos_bad"] = str(bad)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    f = write_inputs(tmp_path_factory.mktemp("cli_datasets"), seed=1)
    _extra_inputs(f, np.random.default_rng(7))
    yield f
    shutil.rmtree(f["root"], ignore_errors=True)


def commands(f, out):
    """name -> (argv, the PNGs it writes, those of them held within
    PNG_TOL instead of equal)."""
    sku = ["--imgs", f["sku_imgs"], "--annotations", f["sku_ann"]]
    gp = ["--imgs", f["test_imgs"], "--annotations", f["test_ann"]]
    model = ["--model", f["gln"], "--conf-thresh", "0.05", "--canvas",
             str(CANVAS), str(CANVAS), "--max-detections",
             str(MAX_DETECTIONS), "--nms-candidates", str(NMS_CANDIDATES)]

    def png(name):
        return str(out / f"{name}.png")

    return {
        "sku_visualize": (["sku110k", "visualize", *sku, "--index", "1",
                           "--out", png("sku")], ["sku"], set()),
        "sku_visualize_flip": (["sku110k", "visualize", *sku, "--flip",
                                "--gaussians", "--out", png("flip")],
                               ["flip", "flip_gauss"], {"flip_gauss"}),
        "sku_visualize_model": (["sku110k", "visualize", *sku, "--index",
                                 "2", "--out", png("model"), *model],
                                ["model"], {"model"}),
        "sku_iter": (["sku110k", "iter", *sku], [], set()),
        "sku_discriminator": (["sku110k", "visualize-discriminator-target",
                               *sku, "--index", "5", "--out", png("disc")],
                              ["disc"], {"disc"}),
        "gp_visualize_test": (["gp", "visualize-test", *gp, "--out",
                               png("gptest")], ["gptest"], set()),
        "gp_visualize_test_store": (["gp", "visualize-test", *gp, "--store",
                                     "1", "--image", "1", "--out",
                                     png("gpstore")], ["gpstore"], set()),
        **{f"gp_test_distribution_{only}": (
            ["gp", "test-distribution", *gp, "--only", only], [], set())
           for only in ("none", "test", "val", "keep2", "skip2")},
        "gp_visualize_planoset": (["gp", "visualize-planoset", *gp,
                                   "--planograms", f["planos"], "--out",
                                   png("planoset")],
                                  ["planoset", "planoset_plano"], set()),
        "gp_mask_test": (["gp", "mask-test", str(
            Path(f["source"]) / "Food" / "Bakery" / "1.jpg"), "--out",
            png("mask")], ["mask"], set()),
        "gp_visualize_train": (["gp", "visualize-train", "--source",
                                f["source"], "--index", "2", "--out",
                                png("gptrain")], ["gptrain"], {"gptrain"}),
        "gp_train_distribution": (["gp", "train-distribution", "--source",
                                   f["source"]], [], set()),
        "gp_train_distribution_out": (
            ["gp", "train-distribution", "--source", f["source"], "--only",
             "Food", "--out", png("treemap")], ["treemap"], set()),
        "gp_fix_dry_run": (["gp", "fix", "--source", f["renamed"], "--out",
                            str(out / "fixed_dry"), "--dry-run"], [], set()),
        "gp_fix": (["gp", "fix", "--source", f["renamed"], "--out",
                    str(out / "fixed")], [], set()),
        "gp_visualize": (["gp", "visualize", "--source", f["source"],
                          "--test-imgs", f["test_imgs"], "--annotations",
                          f["test_ann"], "--seed", "3", "--out",
                          png("gpviz")], ["gpviz"], set()),
        "gp_visualize_baseline": (["gp", "visualize-baseline", "--imgs",
                                   f["test_imgs"], "--annotations",
                                   f["baseline"], "--out", png("baseline")],
                                  ["baseline"], set()),
        "gp_planogram_test": (["gp", "planogram-test", "--planograms",
                               f["planos_bad"]], [], set()),
        "grozi_visualize_test": (["grozi", "visualize-test", "--root",
                                  f["grozi"], "--index", "2", "--out",
                                  png("groziscene")], ["groziscene"],
                                 set()),
        "grozi_visualize_test_max": (["grozi", "visualize-test", "--root",
                                      f["grozi"], "--select-from", "max",
                                      "--out", png("grozimax")],
                                     ["grozimax"], set()),
        "grozi_visualize_test_min": (["grozi", "visualize-test", "--root",
                                      f["grozi"], "--select-from", "min",
                                      "--index", "3", "--out",
                                      png("grozimin")], ["grozimin"],
                                     set()),
        "grozi_visualize": (["grozi", "visualize", "--root", f["grozi"],
                             "--seed", "4", "--out", png("groziviz")],
                            ["groziviz"], set()),
        "grozi_visualize_train": (["grozi", "visualize-train", "--root",
                                   f["grozi"], "--index", "7", "--out",
                                   png("grozitrain")], ["grozitrain"],
                                  set()),
        "internal_visualize_train": (["internal", "visualize-train",
                                      "--root", f["internal_products"],
                                      "--out", png("inttrain")],
                                     ["inttrain"], {"inttrain"}),
        "internal_visualize": (["internal", "visualize", "--root",
                                f["internal"], "--seed", "2", "--out",
                                png("intviz")], ["intviz"], set()),
        "internal_visualize_planoset": (["internal", "visualize-planoset",
                                         "--root", f["internal"], "--index",
                                         "1", "--out", png("intplano")],
                                        ["intplano"], set()),
        "internal_iter_train": (["internal", "iter-train", "--root",
                                 f["internal_products"]], [], set()),
        "visualize_coco": (["visualize-coco", "--imgs", f["sku_imgs"],
                            "--annotations", f["coco_ann"], "--index", "3",
                            "--gaussians", "--out", png("coco")],
                           ["coco", "coco_gauss"], {"coco_gauss"}),
    }


def _run_jax(f, out):
    from cvpce_tpu.cli import cli

    texts = {}
    for name, (args, _, _) in commands(f, out).items():
        res = CliRunner().invoke(cli, ["datasets", *args],
                                 catch_exceptions=False)
        assert res.exit_code == 0, (name, res.output)
        texts[name] = res.output
    return texts


def port_cli(args) -> str:
    from cvpce_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--device", "cpu", "datasets"] + list(args)) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """Each command's printed text and files, JAX's and the port's, each
    in its own output directory."""
    jax_out = tmp_path_factory.mktemp("jax_datasets")
    port_out = tmp_path_factory.mktemp("port_datasets")
    jax_texts = _run_jax(files, jax_out)
    port_texts = {name: port_cli(args) for name, (args, _, _)
                  in commands(files, port_out).items()}
    return jax_texts, jax_out, port_texts, port_out


NAMES = list(commands(
    {k: "x" for k in ("sku_imgs", "sku_ann", "test_imgs", "test_ann", "gln",
                      "planos", "source", "renamed", "baseline",
                      "planos_bad", "grozi", "internal_products",
                      "internal", "coco_ann")}, Path("x")))


@pytest.mark.parametrize("name", NAMES)
def test_command_matches_jax(name, runs, files):
    import matplotlib.image

    jax_texts, jax_out, port_texts, port_out = runs
    _, pngs, within = commands(files, port_out)[name]
    assert port_texts[name] == jax_texts[name].replace(str(jax_out),
                                                       str(port_out))
    for png in pngs:
        got = matplotlib.image.imread(str(port_out / f"{png}.png"))
        want = matplotlib.image.imread(str(jax_out / f"{png}.png"))
        assert got.shape == want.shape, png
        if png in within:
            diff = np.abs(got - want)
            assert diff.max() <= PNG_TOL, (png, diff.max())
            assert (diff > 0).mean() <= PNG_SHARE, (png, (diff > 0).mean())
        else:
            np.testing.assert_array_equal(got, want, err_msg=png)


def test_outputs_are_not_trivial(runs, files):
    """Detections are drawn, the splits count differently, fix copies
    and skips the first file of each directory, planogram-test reports
    its failure, GroZi's selections pick."""
    jax_texts, jax_out, port_texts, port_out = runs
    dists = {port_texts[f"gp_test_distribution_{o}"]
             for o in ("none", "test", "val")}
    assert len(dists) == 3, dists
    assert port_texts["gp_fix"] == "done, 6 files\n"
    fixed = sorted(str(p.relative_to(port_out / "fixed"))
                   for p in (port_out / "fixed").rglob("*.jpg"))
    assert fixed == ["Drinks/1.jpg", "Food/Bakery/1.jpg",
                     "Food/Bakery/2.jpg", "Food/Bakery/3.jpg",
                     "Food/Dairy/1.jpg", "Food/Dairy/2.jpg"]
    for p in (port_out / "fixed").rglob("*.jpg"):
        assert p.read_bytes() == (jax_out / "fixed" / p.relative_to(
            port_out / "fixed")).read_bytes()
    assert not (port_out / "fixed_dry").exists()
    lines = port_texts["gp_planogram_test"].splitlines()
    assert lines[-1] == "1 parsed, 1 failed"
    assert lines[0].startswith("s1_1.json: 6 boxes, ") and \
        lines[1].startswith("s9_9.json: FAILED (")
    assert port_texts["grozi_visualize_test_max"].startswith(
        "1 max-annotated images\n")
    assert port_texts["grozi_visualize_test_min"].startswith(
        "1 min-annotated images\n")


def test_planogram_test_counts_the_directed_edges(files):
    """networkx's DiGraph.number_of_edges() of JAX's graph, on the
    port's Graph."""
    from cvpce_tpu.data.planograms import read_tonioni_planogram as jread
    from cvpce_tpu_torch.cli.datasets import number_of_edges
    from cvpce_tpu_torch.data.planograms import read_tonioni_planogram

    path = str(Path(files["planos"]) / "s1_1.json")
    want = jread(path)[2].number_of_edges()
    assert number_of_edges(read_tonioni_planogram(path)[2]) == want
    assert want == 14  # a 2 x 3 grid: 7 neighbour pairs, both ways


def test_sku_iter_reports_a_broken_photo(files, tmp_path):
    """A photo that does not decode: `FAIL <name>: <the reader's
    error>`, and the rest go on."""
    from cvpce_tpu_torch.data.sku110k import SKU110KDataset

    imgs = tmp_path / "imgs"
    shutil.copytree(files["sku_imgs"], imgs)
    data = (imgs / "train_1.jpg").read_bytes()
    (imgs / "train_1.jpg").write_bytes(data[:len(data) // 2])
    ds = SKU110KDataset(str(imgs), files["sku_ann"], flip_chance=0.0)
    with pytest.raises(OSError) as err:
        ds.load_raw(1)
    text = port_cli(["sku110k", "iter", "--imgs", str(imgs),
                     "--annotations", files["sku_ann"]])
    assert text == f"0/4\nFAIL train_1.jpg: {err.value}\n"


def test_grozi_extract_names_the_missing_video_decoder(files, tmp_path):
    """The port once had no video decoder and raised here. Now, with
    Motion-JPEG videos added to copies of the GroZi layout (video 1 too
    short for its frame 20), the port's command prints the JAX click
    command's lines and writes the same files and index.txt
    (tests/test_torch_grozi_video.py holds the pixels)."""
    from cvpce_tpu.cli import cli

    from cvpce_tpu_torch.data import jpeg

    rng = np.random.default_rng(9)
    roots = [tmp_path / "jax", tmp_path / "port"]
    shutil.copytree(files["grozi"], roots[0])
    (roots[0] / "video").mkdir()
    for v, n in ((1, 15), (2, 8)):
        frames = [testing.mjpeg_frame(jpeg.encode_jpeg(f))
                  for f in testing.smooth_frames(rng, n, 48, 64)]
        testing.write_avi(roots[0] / "video" / f"Shelf_{v}.avi", frames,
                          64, 48)
    shutil.copytree(roots[0], roots[1])
    res = CliRunner().invoke(cli, ["datasets", "grozi", "extract-test-images",
                                   "--root", str(roots[0])],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    assert port_cli(["grozi", "extract-test-images", "--root",
                     str(roots[1])]) == res.output
    assert res.output == ("Not all frames extracted from video 1: "
                          "missing [20]...\n")
    extracted = [sorted(os.listdir(r / "extracted")) for r in roots]
    assert extracted[0] == extracted[1]
    index = [(r / "extracted" / "index.txt").read_text() for r in roots]
    assert index[0] == index[1]
    assert sorted(index[0].split()) == ["1_10.jpg", "2_5.jpg"]
    for r in roots:  # the frames written over the layout's PNGs
        assert (r / "extracted" / "2_5.jpg").read_bytes()[:3] == \
            b"\xff\xd8\xff"


DRAWING = [
    ["sku110k", "visualize", "--out", "o.png"],
    ["sku110k", "visualize-discriminator-target", "--out", "o.png"],
    ["gp", "visualize-test", "--out", "o.png"],
    ["gp", "visualize-planoset", "--out", "o.png"],
    ["gp", "mask-test", __file__, "--out", "o.png"],
    ["gp", "visualize-train", "--out", "o.png"],
    ["gp", "train-distribution", "--out", "o.png"],
    ["gp", "visualize", "--out", "o.png"],
    ["gp", "visualize-baseline", "--out", "o.png"],
    ["grozi", "visualize-test", "--out", "o.png"],
    ["grozi", "visualize", "--out", "o.png"],
    ["grozi", "visualize-train", "--out", "o.png"],
    ["internal", "visualize-train", "--root", "r", "--out", "o.png"],
    ["internal", "visualize", "--root", "r", "--out", "o.png"],
    ["internal", "visualize-planoset", "--root", "r", "--out", "o.png"],
    ["visualize-coco", "--out", "o.png"],
]


@pytest.mark.parametrize("argv", DRAWING, ids=lambda a: "-".join(a[:2]))
def test_drawing_fails_first_without_matplotlib(argv, tmp_path,
                                                monkeypatch):
    """Where matplotlib is missing (the card), every drawing command
    fails naming it before it reads a file (the default data paths do
    not exist in the test's directory) or builds a model."""
    from cvpce_tpu_torch.utils import viz

    monkeypatch.chdir(tmp_path)
    with mock.patch.object(viz, "available", lambda: False), \
            mock.patch("cvpce_tpu_torch.pipeline.proposals."
                       "ProposalGenerator") as build:
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            port_cli(argv + (["--model", "w"] if "sku110k" in argv[:1]
                             and argv[1] == "visualize" else []))
    assert not build.called
    assert os.listdir(tmp_path) == []
