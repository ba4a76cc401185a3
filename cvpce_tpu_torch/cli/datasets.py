"""`datasets` command group: inspection and drawing utilities;
counterpart of cvpce_tpu/cli/datasets.py (reference:
cvpce/cli/datasets/*).

The commands read the datasets through the port's readers (data/) and
print what the JAX package's print. The drawing commands draw what the
JAX package's draw, with matplotlib; they check for it before they read
a dataset or build a model, and where it is missing (the card's machine)
they raise ModuleNotFoundError naming it. `grozi extract-test-images`
reads the Motion-JPEG videos with the port's AVI reader and writes the
frames with its JPEG writer (data/grozi.py).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import defaults
from . import Multiple, UsageError, canvas_option, command, existing_path
from .gln import _require_matplotlib


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _drawing(name: str):
    """pyplot, once matplotlib is known to be installed."""
    from ..utils import viz

    _require_matplotlib(name)
    return viz._plt()


def _save_boxes_viz(img, boxes, out, labels=None, extra_boxes=None):
    """Ground truth in lime; `extra_boxes` (e.g. model detections) in
    cyan."""
    plt = _drawing("the drawing")
    from matplotlib import patches

    fig, ax = plt.subplots(figsize=(12, 9))
    ax.imshow(_np(img))
    for i, (x1, y1, x2, y2) in enumerate(_np(boxes)):
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       fill=False, edgecolor="lime"))
        if labels is not None:
            ax.text(x1, y1, str(labels[i]), color="yellow", fontsize=6)
    if extra_boxes is not None:
        for x1, y1, x2, y2 in _np(extra_boxes):
            ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                           fill=False, edgecolor="cyan",
                                           linestyle="--"))
    ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"saved {out}")


def _save_gaussians(boxes, height, width, out):
    """The boxes' 'simple' Gaussian heatmap target, drawn hot."""
    from ..ops.gaussians import render_gaussians

    plt = _drawing("--gaussians")
    b = torch.as_tensor(np.asarray(boxes), dtype=torch.float32)
    hm = render_gaussians(b, torch.ones(len(b), dtype=torch.bool),
                          height=height, width=width, method="simple")
    plt.imsave(out.replace(".png", "_gauss.png"), _np(hm), cmap="hot")


# ------------------------------------------------------------- sku110k

def sku_visualize(imgs, annotations, index, out, flip, gaussians, model,
                  conf_thresh, canvas, max_detections, nms_candidates,
                  device):
    """One SKU-110K photo with its boxes (cvpce/cli/datasets/sku110k.py
    visualize); --model overlays a GLN's detections."""
    from ..data.sku110k import SKU110KDataset

    _drawing("sku110k visualize")
    ds = SKU110KDataset(imgs, annotations,
                        flip_chance=1.0 if flip else 0.0)
    img, boxes = ds.load_raw(index)
    if flip:
        img = img[:, ::-1]
        flipped = boxes.copy()
        flipped[:, 0] = img.shape[1] - boxes[:, 2]
        flipped[:, 2] = img.shape[1] - boxes[:, 0]
        boxes = flipped
    det_boxes = None
    if model is not None:
        import dataclasses

        from ..pipeline.calibrate import (calibration_dir_for_weights,
                                          resolve_input_norm)
        from ..pipeline.proposals import ProposalGenerator
        from .common import default_gln_config, load_gln_state_dict

        config = dataclasses.replace(default_gln_config(),
                                     canvas_h=canvas[0], canvas_w=canvas[1],
                                     detections_per_img=max_detections,
                                     max_nms_candidates=nms_candidates)
        gen = ProposalGenerator(
            load_gln_state_dict(model, config), config,
            confidence_threshold=conf_thresh,
            input_norm=resolve_input_norm(
                calibration_dir_for_weights(model)), device=device)
        det_boxes = gen.generate_proposals(img)
    _save_boxes_viz(img, boxes, out, extra_boxes=det_boxes)
    if gaussians:
        _save_gaussians(boxes, img.shape[0], img.shape[1], out)


def sku_iter(imgs, annotations, device):
    """Iterate the dataset checking loadability
    (cvpce/cli/datasets/sku110k.py iter)."""
    from ..data.sku110k import SKU110KDataset

    ds = SKU110KDataset(imgs, annotations, flip_chance=0.0)
    for i in range(len(ds)):
        try:
            ds.load_raw(i)
        except Exception as e:  # noqa: BLE001
            print(f"FAIL {ds.index[i]['image_name']}: {e}")
        if i % 100 == 0:
            print(f"{i}/{len(ds)}")


def sku_visualize_discriminator_target(imgs, annotations, index, out,
                                       device):
    """One 'real' 256x256 product crop as the GAN discriminator sees it
    (cvpce/cli/datasets/sku110k.py visualize-discriminator-target)."""
    from ..data.sku110k import TargetDomainDataset
    from ..utils.viz import save_multiple

    _drawing("visualize-discriminator-target")
    ds = TargetDomainDataset(imgs, annotations, skip=defaults.SKU110K_SKIP)
    save_multiple([ds[index]], out)
    print(f"saved {out} ({len(ds)} crops total)")


# ------------------------------------------------------------------ gp

def gp_visualize_test(imgs, annotations, index, store, image_id, out,
                      device):
    """One GP-180 test image with its annotated boxes
    (cvpce/cli/datasets/gp.py visualize-test)."""
    from ..data.grocery import GroceryProductsTestSet

    _drawing("gp visualize-test")
    ds = GroceryProductsTestSet(imgs, annotations)
    if store is not None and image_id is not None:
        found = ds.get_index_for(str(store), str(image_id))
        if found is None:
            raise UsageError(f"no test image s{store}_{image_id}")
        index = found
    img, anns, boxes = ds[index]
    _save_boxes_viz(img, boxes, out, labels=anns)


def gp_test_distribution(imgs, annotations, only, device):
    """Per-category annotation counts (cvpce/cli/datasets/gp.py
    distribution commands)."""
    from collections import Counter

    from ..data.grocery import GroceryProductsTestSet

    n = defaults.GP_TEST_VALIDATION_SET_SIZE
    ds = GroceryProductsTestSet(
        imgs, annotations,
        only=n if only in ("val", "keep2") else None,
        skip=n if only in ("test", "skip2") else None)
    # the per-image split slice on the index itself (no image read)
    sl = slice(ds.toskip, ds.tokeep)
    counts = Counter(a.split("/")[0] if "/" in a else a
                     for e in ds.index for a in e["anns"][sl])
    for name, cnt in counts.most_common():
        print(f"{cnt:6d}  {name}")


def gp_visualize_planoset(imgs, annotations, planograms, index, out,
                          device):
    """A GP-180 test image with its boxes, and its planogram
    (`_plano.png`)."""
    from ..data.planograms import PlanogramTestSet

    _drawing("gp visualize-planoset")
    ds = PlanogramTestSet(imgs, annotations, planograms)
    img, anns, boxes, plano = ds[index]
    _save_boxes_viz(img, boxes, out, labels=anns)
    _save_boxes_viz(np.ones((10, 10, 3)), plano["boxes"],
                    out.replace(".png", "_plano.png"),
                    labels=plano["labels"])


def gp_mask_test(image, out, device):
    """White-background mask visualization (cvpce/cli/datasets/gp.py
    mask-test)."""
    from ..data import transforms as T

    plt = _drawing("gp mask-test")
    img = T.load_image(image)
    mask = T.build_white_background_mask(img)
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(img)
    axes[1].imshow(mask, cmap="gray")
    for ax in axes:
        ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    print(f"saved {out}")


def gp_visualize_train(source, only, index, out, device):
    """Training gallery item: embedder input vs generator crop
    (cvpce/cli/datasets/gp.py visualize-train)."""
    from ..data.grocery import GroceryProductsDataset
    from ..utils.viz import save_multiple

    _drawing("gp visualize-train")
    ds = GroceryProductsDataset(list(source), only=list(only) or None)
    emb, gen, hier = ds[index]
    save_multiple([(emb + 1) / 2, (gen[..., :3] + 1) / 2], out)
    print(f"{'/'.join(hier)} -> {out}")


def gp_train_distribution(source, only, out, device):
    """Top-level category counts of the training gallery
    (cvpce/cli/datasets/gp.py train-distribution treemaps); --out draws
    a treemap."""
    from collections import Counter

    from ..data.grocery import GroceryProductsDataset

    if out:
        _drawing("train-distribution --out")
    ds = GroceryProductsDataset(list(source), random_crop=False,
                                only=list(only) or None)
    counts = Counter(c[0] if c else "(root)" for c in ds.categories)
    for name, n in counts.most_common():
        print(f"{n:6d}  {name}")
    if out:
        from ..utils.viz import category_treemap

        category_treemap(dict(counts), out)
        print(f"saved {out}")


def gp_fix(source, out, dry_run, device):
    """Repair a Grocery Products download whose files were renamed to
    food_<n>.jpg: restore the sequential 1.jpg.. naming the Tonioni
    annotations expect (cvpce/cli/datasets/gp.py fix). The first file in
    each directory is a duplicate artifact and is dropped."""
    import re
    import shutil

    renamed_re = re.compile(r"food_(\d+).jpg")
    stack = [(source, [])]
    copied = 0
    while stack:
        cur, hier = stack.pop()
        files = []
        for entry in os.scandir(cur):
            if entry.is_dir(follow_symlinks=False):
                stack.append((entry.path, hier + [entry.name]))
            elif entry.is_file():
                m = renamed_re.match(entry.name)
                if m:
                    files.append((int(m.group(1)), entry))
        if not files:
            continue
        files = [e for _, e in sorted(files)]
        new_names = sorted(f"{i}.jpg" for i in range(1, len(files)))
        out_path = os.path.join(out, *hier)
        if not dry_run:
            os.makedirs(out_path, exist_ok=True)
        for f, new in zip(files[1:], new_names):  # first entry is garbage
            if dry_run:
                print(f"{f.path} -> {os.path.join(out_path, new)}")
            else:
                shutil.copy(f.path, os.path.join(out_path, new))
                copied += 1
    print(f"{'(dry run) ' if dry_run else ''}done, {copied} files")


def gp_visualize(train_imgs, test_imgs, annotations, seed, out, device):
    """Combined dataset overview (cvpce/cli/datasets/gp.py:125-173): two
    test shelves with annotated boxes plus up to 8 training product
    images, preferring the products that appear in the chosen
    shelves."""
    import re

    plt = _drawing("gp visualize")
    from matplotlib import patches

    from ..data import transforms as T
    from ..data.grocery import GroceryProductsDataset, GroceryProductsTestSet

    ann_re = re.compile(r"^(Food/)?(.*?)\..*$")

    def shorten(ann):
        m = ann_re.match(ann)
        return m.group(2) if m else ann

    trainset = GroceryProductsDataset(list(train_imgs), random_crop=False)
    testset = GroceryProductsTestSet(test_imgs, annotations)
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(testset), size=min(2, len(testset)),
                       replace=False)
    samples = [testset[int(i)] for i in picks]

    uniq = {a for _, anns, _ in samples for a in anns}
    prod_idx = [i for i in (trainset.index_for_ann(a) for a in sorted(uniq))
                if i is not None][:8]
    while len(prod_idx) < min(8, len(trainset)):
        j = int(rng.integers(0, len(trainset)))
        if j not in prod_idx:
            prod_idx.append(j)

    fig = plt.figure(figsize=(16, 12))
    for col, (img, anns, boxes) in enumerate(samples):
        ax = fig.add_subplot(3, 2, col + 1)
        ax.imshow(img)
        for (x1, y1, x2, y2), a in zip(boxes, anns):
            ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                           fill=False, edgecolor="lime"))
            ax.text(x1, y1, shorten(a), color="yellow", fontsize=5)
        ax.axis("off")
    for i, idx in enumerate(prod_idx):
        ax = fig.add_subplot(3, 4, 5 + i)
        ax.imshow(T.load_image(trainset.paths[idx]))
        ax.set_title(shorten(trainset.annotations[idx]), fontsize=7)
        ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"saved {out}")


def gp_visualize_baseline(imgs, annotations, index, out, device):
    """Tonioni baseline annotations overlay
    (cvpce/cli/datasets/gp.py visualize-baseline)."""
    from ..data.grocery import GPBaselineDataset

    _drawing("gp visualize-baseline")
    ds = GPBaselineDataset(imgs, annotations)
    img, boxes = ds[index]
    _save_boxes_viz(img, boxes, out)


def number_of_edges(g) -> int:
    """The directed edges of a pipeline/planograms.py Graph, as networkx's
    DiGraph.number_of_edges() counts them."""
    return sum(len(out) for out in g.adj.values())


def gp_planogram_test(planograms, device):
    """Parse every GP-180 planogram JSON and report box counts / failures
    (cvpce/cli/datasets/gp.py planogram-test)."""
    from ..data.planograms import read_tonioni_planogram

    ok, failed = 0, 0
    for entry in sorted(os.scandir(planograms), key=lambda e: e.name):
        if not entry.name.endswith(".json"):
            continue
        try:
            boxes, labels, g = read_tonioni_planogram(entry.path)
            print(f"{entry.name}: {len(boxes)} boxes, "
                  f"{number_of_edges(g)} edges")
            ok += 1
        except Exception as e:  # noqa: BLE001
            print(f"{entry.name}: FAILED ({e})")
            failed += 1
    print(f"{ok} parsed, {failed} failed")


# --------------------------------------------------------------- grozi

def grozi_extract(root, device):
    """Extract GroZi-120's annotated test frames from its videos
    (cvpce/cli/datasets/grozi.py)."""
    from ..data.grozi import extract_grozi_test_imgs

    extract_grozi_test_imgs(root)


def grozi_visualize_test(root, index, select_from, out, device):
    """One GroZi-120 test frame with its boxes
    (cvpce/cli/datasets/grozi.py visualize-test)."""
    from ..data.grozi import GroZiTestSet

    _drawing("grozi visualize-test")
    ds = GroZiTestSet(root)
    if select_from != "none":
        idxset = (ds.least_annotated() if select_from == "min"
                  else ds.most_annotated())
        print(f"{len(idxset)} {select_from}-annotated images")
        index = idxset[index % len(idxset)]
    img, anns, boxes = ds[index]
    print(f"annotations in image: {len(anns)}")
    _save_boxes_viz(img, boxes, out, labels=list(anns))


def grozi_visualize(root, out, seed, device):
    """Dataset overview: 2 random test frames with boxes + the training
    images of the products they contain, padded to 8 with random products
    (cvpce/cli/datasets/grozi.py visualize)."""
    from ..data.grozi import GroZiDataset, GroZiTestSet
    from ..utils.viz import save_dataset_sample

    _drawing("grozi visualize")
    rng = np.random.default_rng(seed)
    train_set = GroZiDataset(root)
    test_set = GroZiTestSet(root)
    picks = [test_set[int(rng.integers(len(test_set)))] for _ in range(2)]
    test_imgs = [p[0] for p in picks]
    test_anns = [[int(a) for a in p[1]] for p in picks]
    test_boxes = [p[2] for p in picks]

    uniq = sorted(set(test_anns[0]) | set(test_anns[1]))
    train_imgs, train_anns = [], []
    for ann in uniq:
        idx = train_set.index_for_ann(ann)
        if idx is not None:
            img, a = train_set[idx]
            train_imgs.append(img)
            train_anns.append(a)
    while len(train_imgs) < 8:
        img, a = train_set[int(rng.integers(len(train_set)))]
        train_imgs.append(img)
        train_anns.append(a)
    save_dataset_sample(test_imgs, test_boxes, test_anns,
                        train_imgs, train_anns, out)
    print(f"saved {out} (test products: {uniq})")


def grozi_visualize_train(root, index, out, device):
    """One GroZi-120 training image (cvpce/cli/datasets/grozi.py
    visualize-train)."""
    from ..data.grozi import GroZiDataset
    from ..utils.viz import save_multiple

    _drawing("grozi visualize-train")
    ds = GroZiDataset(root)
    img, ann = ds[index]
    save_multiple([img], out)
    print(f"product {ann} -> {out}")


# ------------------------------------------------------------ internal

def internal_visualize_train(root, index, out, seed, device):
    """One training item: embedder input / generator input / alpha mask
    triple + its hierarchy and annotation
    (cvpce/cli/datasets/internal.py visualize-train)."""
    from ..data.grocery import InternalTrainSet
    from ..ops.image import scale_from_tanh
    from ..utils.viz import save_multiple

    _drawing("internal visualize-train")
    ds = InternalTrainSet(root, include_annotations=True,
                          include_masks=True)
    if index is None:
        index = int(np.random.default_rng(seed).integers(len(ds)))
    img, gen, hier, ann = ds[index]
    mask = gen[..., 3]
    save_multiple([scale_from_tanh(img), scale_from_tanh(gen[..., :3]),
                   torch.stack([mask, mask, mask], -1)], out)
    print(" - ".join(hier))
    print(f"{ann} -> {out}")


def internal_visualize_overview(root, out, seed, device):
    """Dataset overview: 2 random planoset scenes + 8 random training
    products (cvpce/cli/datasets/internal.py visualize)."""
    from ..data.grocery import InternalTrainSet
    from ..data.planograms import InternalPlanoSet
    from ..ops.image import scale_from_tanh
    from ..utils.viz import save_dataset_sample

    _drawing("internal visualize")
    rng = np.random.default_rng(seed)
    test_set = InternalPlanoSet(root)
    train_set = InternalTrainSet(os.path.join(root, "ConvertedProducts"),
                                 include_annotations=True,
                                 random_crop=False, resize=False)
    test_imgs = [test_set[int(rng.integers(len(test_set)))][0]
                 for _ in range(2)]
    train_imgs, train_anns = [], []
    for _ in range(8):
        img, _, _, ann = train_set[int(rng.integers(len(train_set)))]
        train_imgs.append(scale_from_tanh(img))
        train_anns.append(ann[:8])
    print(f"Different products: {len(set(train_set.annotations))}")
    save_dataset_sample(test_imgs, [[], []], [[], []],
                        train_imgs, train_anns, out)
    print(f"saved {out}")


def internal_visualize(root, index, out, device):
    """One internal planoset scene with its planogram's boxes
    (cvpce/cli/datasets/internal.py visualize-planoset)."""
    from ..data.planograms import InternalPlanoSet

    _drawing("internal visualize-planoset")
    ds = InternalPlanoSet(root)
    img, plano = ds[index]
    _save_boxes_viz(img, plano["boxes"], out, labels=plano["labels"])


def internal_iter_train(root, device):
    """Iterate the internal trainset checking loadability
    (cvpce/cli/datasets/internal.py iter-train)."""
    from ..data.grocery import InternalTrainSet

    ds = InternalTrainSet(root)
    for i in range(len(ds)):
        try:
            ds[i]
        except Exception as e:  # noqa: BLE001
            print(f"FAIL {ds.paths[i]}: {e}")
        if i % 100 == 0:
            print(f"{i}/{len(ds)}")


# ---------------------------------------------------------------- coco

def visualize_coco(imgs, annotations, index, out, gaussians, device):
    """COCO visualization + optional Gaussian-target preview
    (cvpce/cli/datasets/misc.py, without pycocotools)."""
    from ..data.coco import CocoDetectionDataset

    _drawing("visualize-coco")
    ds = CocoDetectionDataset(imgs, annotations)
    img, entry = ds[index]
    labels = [ds.categories.get(int(c), str(c)) for c in entry["labels"]]
    _save_boxes_viz(img, entry["boxes"], out, labels=labels)
    if gaussians:
        _save_gaussians(entry["boxes"], img.shape[0], img.shape[1], out)
        print(f"saved {out.replace('.png', '_gauss.png')}")


# ------------------------------------------------------------ register

def _group(commands, name: str, text: str):
    parser = commands.add_parser(name, help=text, description=text)
    return parser.add_subparsers(dest="subgroup_command", metavar="COMMAND",
                                 required=True)


def _sku_options(p) -> None:
    p.add_argument("--imgs", default=defaults.SKU110K_IMG_DIR)
    p.add_argument("--annotations", default=defaults.SKU110K_ANNOTATION_FILE)


def _gp_test_options(p) -> None:
    p.add_argument("--imgs", default=defaults.GP_TEST_DIR)
    p.add_argument("--annotations", default=defaults.GP_ANN_DIR)


def register(commands) -> None:
    text = "Dataset inspection and visualization."
    datasets = commands.add_parser("datasets", help=text, description=text)
    group = datasets.add_subparsers(dest="group_command", metavar="COMMAND",
                                    required=True)

    sku = _group(group, "sku110k", "SKU-110K (cvpce/cli/datasets/sku110k.py).")
    p = command(sku, "visualize", sku_visualize)
    _sku_options(p)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--flip", action="store_true",
                   help="show the flipped sample "
                        "(cvpce/cli/datasets/sku110k.py:40)")
    p.add_argument("--gaussians", action="store_true",
                   help="also render the heatmap target")
    p.add_argument("--model", default=None,
                   help="GLN weights: overlay detections over the ground "
                        "truth (cvpce/cli/datasets/sku110k.py:42)")
    p.add_argument("--conf-thresh", type=float, default=0.45)
    canvas_option(p, "detector canvas for --model")
    p.add_argument("--max-detections", type=int, default=1000)
    p.add_argument("--nms-candidates", type=int, default=5120)
    p = command(sku, "iter", sku_iter)
    _sku_options(p)
    p = command(sku, "visualize-discriminator-target",
                sku_visualize_discriminator_target)
    _sku_options(p)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)

    gp = _group(group, "gp", "Grocery Products (cvpce/cli/datasets/gp.py).")
    p = command(gp, "visualize-test", gp_visualize_test)
    _gp_test_options(p)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--store", type=int, default=None,
                   help="select by store id instead of --index "
                        "(cvpce/cli/datasets/gp.py:75)")
    p.add_argument("--image", dest="image_id", type=int, default=None,
                   help="select by image id (with --store)")
    p.add_argument("--out", required=True)
    p = command(gp, "test-distribution", gp_test_distribution)
    _gp_test_options(p)
    p.add_argument("--only", choices=["none", "test", "val", "keep2",
                                      "skip2"], default="none",
                   help="full set, or the test (skip first 2 anns/img) / "
                        "validation (keep first 2) split "
                        "(cvpce/cli/datasets/gp.py:201)")
    p = command(gp, "visualize-planoset", gp_visualize_planoset)
    _gp_test_options(p)
    p.add_argument("--planograms", default=defaults.GP_PLANO_DIR)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)
    p = command(gp, "mask-test", gp_mask_test)
    p.add_argument("image", type=existing_path)
    p.add_argument("--out", required=True)
    p = command(gp, "visualize-train", gp_visualize_train)
    p.add_argument("--source", action=Multiple,
                   default=defaults.GP_TRAIN_FOLDERS)
    p.add_argument("--only", action=Multiple, default=(),
                   help="top-level group filter "
                        "(cvpce/cli/datasets/gp.py:55)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)
    p = command(gp, "train-distribution", gp_train_distribution)
    p.add_argument("--source", action=Multiple,
                   default=defaults.GP_TRAIN_FOLDERS)
    p.add_argument("--only", action=Multiple, default=(),
                   help="top-level group filter "
                        "(cvpce/cli/datasets/gp.py:182)")
    p.add_argument("--out", default=None, help="save a treemap here")
    p = command(gp, "fix", gp_fix)
    p.add_argument("--source", required=True, type=_existing_dir)
    p.add_argument("--out", required=True, type=_not_a_file)
    p.add_argument("--dry-run", action="store_true")
    p = command(gp, "visualize", gp_visualize)
    p.add_argument("--source", dest="train_imgs", action=Multiple,
                   default=defaults.GP_TRAIN_FOLDERS)
    p.add_argument("--test-imgs", default=defaults.GP_TEST_DIR)
    p.add_argument("--annotations", default=defaults.GP_ANN_DIR)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p = command(gp, "visualize-baseline", gp_visualize_baseline)
    p.add_argument("--imgs", default=defaults.GP_TEST_DIR)
    p.add_argument("--annotations", default=defaults.GP_BASELINE_ANN_FILE)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)
    p = command(gp, "planogram-test", gp_planogram_test)
    p.add_argument("--planograms", default=defaults.GP_PLANO_DIR)

    grozi = _group(group, "grozi", "GroZi-120 (cvpce/cli/datasets/grozi.py).")
    p = command(grozi, "extract-test-images", grozi_extract)
    p.add_argument("--root", default=defaults.GROZI_ROOT)
    p = command(grozi, "visualize-test", grozi_visualize_test)
    p.add_argument("--root", default=defaults.GROZI_ROOT)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--select-from", choices=["none", "min", "max"],
                   default="none",
                   help="pick --index within the least/most annotated "
                        "images (cvpce/cli/datasets/grozi.py:32)")
    p.add_argument("--out", required=True)
    p = command(grozi, "visualize", grozi_visualize)
    p.add_argument("--root", default=defaults.GROZI_ROOT)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p = command(grozi, "visualize-train", grozi_visualize_train)
    p.add_argument("--root", default=defaults.GROZI_ROOT)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)

    internal = _group(group, "internal",
                      "Internal dataset (cvpce/cli/datasets/internal.py).")
    p = command(internal, "visualize-train", internal_visualize_train)
    p.add_argument("--root", required=True)
    p.add_argument("--index", type=int, default=None,
                   help="item index; random when omitted")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p = command(internal, "visualize", internal_visualize_overview)
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p = command(internal, "visualize-planoset", internal_visualize)
    p.add_argument("--root", required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)
    p = command(internal, "iter-train", internal_iter_train)
    p.add_argument("--root", required=True)

    p = command(group, "visualize-coco", visualize_coco)
    p.add_argument("--imgs", default=defaults.DATA_DIR + "/coco/val2017")
    p.add_argument("--annotations",
                   default=defaults.DATA_DIR
                   + "/coco/annotations/instances_val2017.json")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--gaussians", action="store_true",
                   help="also render the Gaussian target preview")


def _existing_dir(value: str) -> str:
    """click.Path(exists=True, file_okay=False)."""
    existing_path(value)
    if not os.path.isdir(value):
        raise argparse.ArgumentTypeError(
            f"Directory '{value}' is a file.")
    return value


def _not_a_file(value: str) -> str:
    """click.Path(file_okay=False)."""
    if os.path.isfile(value):
        raise argparse.ArgumentTypeError(
            f"Directory '{value}' is a file.")
    return value
