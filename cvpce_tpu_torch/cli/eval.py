"""Top-level evaluation commands; counterpart of cvpce_tpu/cli/eval.py.

Every command serves the pipeline of `build_pipeline`: the GLN from
`--gln-weights` (a reference or port GLN checkpoint file), the MACVGG
embedder from `--encoder-weights` (torchvision vgg16_bn, a reference
MACVGG or the port's DIHE training checkpoint; seeded when absent), and
a Classifier over the Grocery Products folders of `--source` or the
saved index of `--index`. `--fast` serves bf16 convs and an int8-static
embedder (exact top-k). `--sharded-gallery` shards the gallery over the
ranks of a process group: torchrun's (parallel/multihost.py reads its
environment), or a group of this process alone, which ends with the
command.
"""
from __future__ import annotations

import contextlib
import functools
import json
import socket
import sys

import numpy as np

from ..data import defaults
from . import Multiple, UsageError, canvas_option, command, existing_path
from .common import default_gln_config, load_embedder, load_gln_state_dict


def _pipeline_options(parser) -> None:
    parser.add_argument("--gln-weights", required=True)
    parser.add_argument("--encoder-weights", default=None)
    parser.add_argument("--source", action=Multiple,
                        default=defaults.GP_TRAIN_FOLDERS)
    parser.add_argument("--test-imgs", default=defaults.GP_TEST_DIR)
    parser.add_argument("--test-annotations", default=defaults.GP_ANN_DIR)
    parser.add_argument("--index", default=None,
                        help="prebuilt classifier index")
    parser.add_argument(
        "--confidence", default="auto",
        help="detection serving threshold; 'auto' reads the max-F1 "
             "calibration saved next to the GLN checkpoint "
             "(pipeline/calibrate.py) and falls back to the reference's "
             "fixed 0.5 (cvpce/production.py:14) when absent")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 convs and an int8-static embedder")
    canvas_option(parser)
    parser.add_argument("--max-detections", type=int, default=1000,
                        help="detections_per_img cap")
    parser.add_argument("--nms-candidates", type=int, default=5120,
                        help="NMS candidate cap across levels")
    parser.add_argument("--sharded-gallery", action="store_true",
                        help="shard the gallery index over the process "
                             "group's ranks (ops/knn_sharded.py)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def gallery_group(sharded: bool, device):
    """The process group of `--sharded-gallery`: the one already set up,
    torchrun's, or one of this process alone that ends with the block."""
    import torch.distributed as dist

    from ..parallel.multihost import initialize_multihost

    started = False
    if sharded and not dist.is_initialized():
        initialize_multihost(device=device)
        if not dist.is_initialized():
            initialize_multihost(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                                 device=device)
        started = True
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def _in_gallery_group(run):
    @functools.wraps(run)
    def wrapped(*, sharded_gallery, device, **kwargs):
        with gallery_group(sharded_gallery, device):
            return run(sharded_gallery=sharded_gallery, device=device,
                       **kwargs)
    return wrapped


def build_pipeline(gln_weights, encoder_weights, source, index, confidence,
                   k=1, fast=False, sharded_gallery=False,
                   canvas=(832, 1344), max_detections=1000,
                   nms_candidates=5120, device="cuda"):
    """(ProposalGenerator, Classifier) as cvpce/cli/eval.py:_build_pipeline
    builds them, on `device`; the serving threshold and its provenance
    go to stderr."""
    import dataclasses

    from ..data.grocery import GroceryProductsDataset
    from ..pipeline.calibrate import (calibration_dir_for_weights,
                                      load_calibration, resolve_input_norm,
                                      resolve_threshold)
    from ..pipeline.classifier import Classifier
    from ..pipeline.proposals import ProposalGenerator

    config = dataclasses.replace(
        default_gln_config(fast), canvas_h=canvas[0], canvas_w=canvas[1],
        detections_per_img=max_detections,
        max_nms_candidates=nms_candidates)
    state_dict = load_gln_state_dict(gln_weights, config)
    ckpt_dir = calibration_dir_for_weights(gln_weights)
    threshold = resolve_threshold(confidence, ckpt_dir)
    provenance = ("pinned" if confidence not in (None, "auto")
                  else "calibrated" if load_calibration(ckpt_dir)
                  else "reference default")
    print(f"serving confidence threshold: {threshold:.4f} ({provenance})",
          file=sys.stderr)
    generator = ProposalGenerator(
        state_dict, config, confidence_threshold=threshold,
        input_norm=resolve_input_norm(ckpt_dir), device=device)
    encoder_fn, emb_size = load_embedder(encoder_weights, int8=fast,
                                         device=device)
    mesh = None
    if sharded_gallery:
        from ..parallel.mesh import data_parallel_mesh

        mesh = data_parallel_mesh(device=device)
    if index:
        classifier = Classifier(encoder_fn, emb_size, load=index, k=k,
                                mesh=mesh, device=device)
    else:
        sampleset = GroceryProductsDataset(list(source), random_crop=False,
                                           include_annotations=True)
        classifier = Classifier(encoder_fn, emb_size, sampleset, k=k,
                                mesh=mesh, device=device)
    return generator, classifier


def _pipeline(options) -> tuple:
    """build_pipeline from a command's pipeline options."""
    names = ("gln_weights", "encoder_weights", "source", "index",
             "confidence", "fast", "sharded_gallery", "canvas",
             "max_detections", "nms_candidates", "device")
    return build_pipeline(**{n: options[n] for n in names})


def detection_summary(per_class, overall, thresholds) -> dict:
    """eval-product-detection's JSON."""
    from ..eval.detection import mean_average_metrics

    mam = mean_average_metrics(per_class, thresholds)
    return {
        "overall": {str(t): {k: float(v) for k, v in d.items()}
                    for t, d in overall.items()},
        "mean": {str(t): d for t, d in mam.items()},
    }


@_in_gallery_group
def eval_product_detection(iou_thresholds, coco, out, **pipeline):
    """GLN+DIHE product detection mAP/mAR300 on GP-180
    (cvpce/cli/eval.py:12-71)."""
    from ..data.grocery import GroceryProductsTestSet
    from ..eval.detection import evaluate_detections

    generator, classifier = _pipeline(pipeline)
    testset = GroceryProductsTestSet(pipeline["test_imgs"],
                                     pipeline["test_annotations"])
    thresholds = tuple(np.arange(0.5, 1.0, 0.05).round(2)) if coco \
        else tuple(iou_thresholds)
    per_class, overall = evaluate_detections(generator, classifier, testset,
                                             thresholds=thresholds)
    result = detection_summary(per_class, overall, thresholds)
    print(json.dumps(result, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump(result, f)


def planogram_set(test_imgs, test_annotations, plano_dir, internal):
    from ..data.planograms import InternalPlanoSet, PlanogramTestSet

    if internal:
        return InternalPlanoSet(internal)
    return PlanogramTestSet(test_imgs, test_annotations, plano_dir)


@_in_gallery_group
def eval_planograms(plano_dir, internal, verbose, color_correct, out,
                    **pipeline):
    """End-to-end compliance eval: mean accuracy + MSE vs ground truth
    (cvpce/cli/eval.py:160-240)."""
    from ..eval.compliance import evaluate_planograms
    from ..pipeline.evaluator import PlanogramComparator, PlanogramEvaluator

    generator, classifier = _pipeline(pipeline)
    planoset = planogram_set(pipeline["test_imgs"],
                             pipeline["test_annotations"], plano_dir,
                             internal)
    evaluator = PlanogramEvaluator(generator, classifier,
                                   PlanogramComparator(
                                       device=pipeline["device"]),
                                   color_correct=color_correct)
    result = evaluate_planograms(evaluator, planoset)
    print(json.dumps({k: v for k, v in result.items()
                      if verbose or k != "per_image"}, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump(result, f)


@_in_gallery_group
def rebuild_scene(image, out, **pipeline):
    """Paste gallery images at detection positions
    (cvpce/cli/eval.py:73-158)."""
    from ..utils.viz import _plt

    plt = _plt()  # before the pipeline, as the JAX command imports it

    from ..data import transforms as T
    from ..data.grocery import GroceryProductsDataset

    generator, classifier = _pipeline(pipeline)
    gallery = GroceryProductsDataset(list(pipeline["source"]),
                                     random_crop=False,
                                     include_annotations=True)
    img = T.load_image(image)
    res = generator.detect_with_crops(img)
    labels = [ann[0] for ann in classifier.classify(res["crops"])] \
        if len(res["crops"]) else []

    pasted = np.ones_like(img)
    for box, label in zip(res["boxes"].astype(int), labels):
        idx = gallery.index_for_ann(label)
        if idx is None:
            continue
        x1, y1, x2, y2 = np.clip(box, 0, None)
        x2 = min(x2, img.shape[1])
        y2 = min(y2, img.shape[0])
        if x2 - x1 < 2 or y2 - y1 < 2:
            continue
        product = T.load_image(gallery.paths[idx])
        pasted[y1:y2, x1:x2] = T.resize_bilinear(
            product, y2 - y1, x2 - x1).cpu().numpy()
    fig, axes = plt.subplots(1, 2, figsize=(16, 9))
    axes[0].imshow(img)
    axes[1].imshow(pasted)
    for ax in axes:
        ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"saved {out} ({len(labels)} products)")


@_in_gallery_group
def plot_planogram_eval(plano_dir, internal, plano_idx, store, image_id, out,
                        **pipeline):
    """Step-by-step compliance visualization (cvpce/cli/eval.py:242-371):
    detections, planogram layout, matched/missing products.

    Without --internal, --store and --image are checked before the
    pipeline is built."""
    from ..utils.viz import _plt

    plt = _plt()  # before the pipeline, as the JAX command imports it
    from matplotlib import patches

    from ..pipeline import planograms as pg

    if not internal and (store is None or image_id is None):
        raise UsageError("--store/--image are required without --internal")
    generator, classifier = _pipeline(pipeline)
    planoset = planogram_set(pipeline["test_imgs"],
                             pipeline["test_annotations"], plano_dir,
                             internal)
    if internal:
        img, iplano = planoset[plano_idx]
        boxes = np.asarray(iplano["boxes"], np.float32)
        plano = {"boxes": boxes, "labels": list(iplano["labels"]),
                 "graph": pg.build_graph(boxes, list(iplano["labels"]))}
    else:
        idx = planoset.get_index_for(store, image_id)
        if idx is None:
            raise UsageError(f"no test image s{store}_{image_id}")
        img, _, _, plano = planoset[idx]

    res = generator.detect_with_crops(img)
    labels = [a[0] for a in classifier.classify(res["crops"])] \
        if len(res["crops"]) else []
    ge = plano["graph"]
    ga = pg.build_graph(res["boxes"], labels) if len(labels) else None
    matching = pg.large_common_subgraph(ge, ga) if ga is not None else set()

    fig, axes = plt.subplots(1, 3, figsize=(22, 8))
    axes[0].imshow(img)
    for (x1, y1, x2, y2), _ in zip(res["boxes"], labels):
        axes[0].add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                            fill=False, edgecolor="lime"))
    axes[0].set_title(f"detections ({len(labels)})")

    pb = plano["boxes"]
    axes[1].set_xlim(pb[:, 0].min() - 1, pb[:, 2].max() + 1)
    axes[1].set_ylim(pb[:, 1].min() - 1, pb[:, 3].max() + 1)
    matched1 = {n1 for n1, _ in matching}
    for i, (x1, y1, x2, y2) in enumerate(pb):
        color = "green" if i in matched1 else "red"
        axes[1].add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                            fill=False, edgecolor=color))
    axes[1].set_title(f"planogram (matched {len(matching)}/{len(pb)})")

    score = None
    if matching:
        found, _, missing_pos, _ = pg.finalize_via_ransac(
            matching, pb, res["boxes"], plano["labels"], labels,
            reproj_threshold=min(img.shape[:2]) * 0.01,
            device=pipeline["device"])
        if found is not None:
            score = float(found.sum() / len(found))
            axes[2].imshow(img)
            for x1, y1, x2, y2 in missing_pos:
                axes[2].add_patch(patches.Rectangle(
                    (x1, y1), x2 - x1, y2 - y1, fill=False,
                    edgecolor="red", linewidth=2))
    axes[2].set_title(f"missing products (compliance {score})")
    axes[0].axis("off")
    axes[2].axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"saved {out}; compliance={score}")


def register(commands) -> None:
    p = command(commands, "eval-product-detection", eval_product_detection)
    _pipeline_options(p)
    p.add_argument("--iou-threshold", "-t", dest="iou_thresholds",
                   action=Multiple, type=float, default=(0.5,),
                   help="IoU thresholds (cvpce/cli/eval.py:32)")
    p.add_argument("--coco", action="store_true",
                   help="IoU sweep 0.5:0.95 instead of --iou-threshold")
    p.add_argument("--out", default=None)

    p = command(commands, "eval-planograms", eval_planograms)
    _pipeline_options(p)
    p.add_argument("--planograms", dest="plano_dir",
                   default=defaults.GP_PLANO_DIR)
    p.add_argument("--internal", default=None,
                   help="internal planoset dir instead of GP-180")
    p.add_argument("--verbose", action="store_true",
                   help="include per-image results "
                        "(cvpce/cli/eval.py:189)")
    p.add_argument("--color-correct", action="store_true",
                   help="remove the scene-level white-balance cast from "
                        "the classify crops (pipeline/colorcorrect.py); "
                        "detection input stays raw")
    p.add_argument("--out", default=None)

    p = command(commands, "rebuild-scene", rebuild_scene)
    _pipeline_options(p)
    p.add_argument("image", type=existing_path)
    p.add_argument("--out", required=True)

    p = command(commands, "plot-planogram-eval", plot_planogram_eval)
    _pipeline_options(p)
    p.add_argument("--planograms", dest="plano_dir",
                   default=defaults.GP_PLANO_DIR)
    p.add_argument("--internal", default=None,
                   help="internal planoset dir instead of GP-180 "
                        "(cvpce/cli/eval.py:268)")
    p.add_argument("--plano-idx", type=int, default=0,
                   help="index into the internal planoset "
                        "(cvpce/cli/eval.py:271)")
    p.add_argument("--store", default=None, help="GP-180 store id")
    p.add_argument("--image", dest="image_id", default=None,
                   help="GP-180 image id")
    p.add_argument("--out", required=True)
