"""`misc` command group; counterpart of cvpce_tpu/cli/misc.py."""
from __future__ import annotations

import json

from ..models.gln import GLNConfig
from . import canvas_option, command, existing_path
from .common import load_embedder, load_gln_state_dict


def small_canvas_config(canvas) -> GLNConfig:
    """The demo commands' GLNConfig: candidate and detection caps cut to
    the canvas's stride-8 cell count."""
    h, w = canvas
    return GLNConfig(canvas_h=h, canvas_w=w,
                     max_nms_candidates=min(5120, (h // 8) * (w // 8)),
                     detections_per_img=min(1000, (h // 8) * (w // 8)))


class TanhFolderSet:
    """SimpleFolderSet items ([0, 1] 256 crops) in the classifier's tanh
    scale."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        from ..data import transforms as T

        img, gen, c1, c2 = self.base[i]
        return T.scale_to_tanh(img), T.scale_to_tanh(gen), c1, c2


def read_planogram(plano_path: str) -> dict:
    """A JSON planogram `[{label, box: [x1, y1, x2, y2]}, ...]`."""
    import numpy as np

    with open(plano_path) as f:
        plano_json = json.load(f)
    return {"boxes": np.asarray([e["box"] for e in plano_json], np.float32),
            "labels": [e["label"] for e in plano_json]}


def pipeline_demo(image, gallery, plano_path, gln_weights, encoder_weights,
                  confidence, canvas, color_correct, device):
    """End-to-end demo on an arbitrary folder dataset + JSON planogram
    (cvpce/cli/misc.py:104-253).

    Prints {"compliance": ...}."""
    from ..data import transforms as T
    from ..data.grocery import SimpleFolderSet
    from ..pipeline.calibrate import (calibration_dir_for_weights,
                                      resolve_input_norm, resolve_threshold)
    from ..pipeline.classifier import Classifier
    from ..pipeline.evaluator import PlanogramComparator, PlanogramEvaluator
    from ..pipeline.proposals import ProposalGenerator

    config = small_canvas_config(canvas)
    state_dict = load_gln_state_dict(gln_weights, config)
    ckpt_dir = calibration_dir_for_weights(gln_weights)
    threshold = resolve_threshold(confidence, ckpt_dir)
    generator = ProposalGenerator(state_dict, config,
                                  confidence_threshold=threshold,
                                  input_norm=resolve_input_norm(ckpt_dir),
                                  device=device)
    encoder_fn, emb_size = load_embedder(encoder_weights, device=device)
    classifier = Classifier(encoder_fn, emb_size,
                            TanhFolderSet(SimpleFolderSet(gallery)),
                            device=device)
    evaluator = PlanogramEvaluator(generator, classifier,
                                   PlanogramComparator(device=device),
                                   color_correct=color_correct)
    compliance = evaluator.evaluate(T.load_image(image),
                                    read_planogram(plano_path))
    print(json.dumps({"compliance": float(compliance)}))


def _sanitize(obj):
    """NaN (an empty area bucket) -> null, for strict JSON."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, float) and obj != obj:
        return None
    return obj


def retinanet_coco_test(imgs, annotations, weights, limit, coco_sweep,
                        canvas, device):
    """Base-detector sanity check on COCO (cvpce/cli/misc.py:29-101).

    Both graders run on the same detections: the in-house metric suite
    (ops/metrics.py, 11-point VOC AP) and the pycocotools-equivalent
    COCO protocol (eval/coco_protocol.py: 101-point AP, area ranges,
    maxDets)."""
    import numpy as np

    from ..data.coco import CocoDetectionDataset
    from ..eval.coco_protocol import ImageDetections, evaluate_coco_protocol
    from ..eval.proposals import DetectionEvalAdapter, evaluate_gln
    from .gln import eval_summary

    config = small_canvas_config(canvas)
    # index the dataset before the model so that bad paths fail fast
    base = CocoDetectionDataset(imgs, annotations)
    state_dict = load_gln_state_dict(weights, config)
    if limit:
        base.index = base.index[:limit]
    adapter = DetectionEvalAdapter(base, lambda it: (it[0], it[1]["boxes"]),
                                   config.canvas_h, config.canvas_w,
                                   device=device)
    thresholds = (tuple(np.arange(0.5, 1.0, 0.05).round(2))
                  if coco_sweep else (0.5,))
    res, (tgts, preds, confs) = evaluate_gln(
        state_dict, adapter, config, thresholds=thresholds,
        return_detections=True, device=device)
    referee = evaluate_coco_protocol({None: [
        ImageDetections(p, c, t) for t, p, c in zip(tgts, preds, confs)]})
    summary = {
        "reference_protocol": eval_summary(res),
        "coco_protocol": {k: v for k, v in referee.items()
                          if k != "per_threshold"},
    }
    print(json.dumps(_sanitize(summary), indent=2))


def register(commands) -> None:
    misc = commands.add_parser("misc", help="Miscellaneous utilities.",
                               description="Miscellaneous utilities.")
    group = misc.add_subparsers(dest="group_command", metavar="COMMAND",
                                required=True)

    p = command(group, "pipeline-demo", pipeline_demo)
    p.add_argument("image", type=existing_path)
    p.add_argument("--gallery", required=True, type=existing_path,
                   help="folder with one image per product, file name = "
                        "label")
    p.add_argument("--planogram", dest="plano_path", required=True,
                   type=existing_path,
                   help="JSON planogram: [{label, box: [x1,y1,x2,y2]}, "
                        "...]")
    p.add_argument("--gln-weights", default=None,
                   help="GLN checkpoint; random init if omitted (demo "
                        "mode)")
    p.add_argument("--encoder-weights", default=None)
    p.add_argument("--confidence", default="auto",
                   help="'auto' reads the max-F1 calibration saved next "
                        "to --gln-weights, else the reference's fixed 0.5")
    canvas_option(p)
    p.add_argument("--color-correct", action="store_true",
                   help="remove the scene-level white-balance cast from "
                        "the classify crops (pipeline/colorcorrect.py)")

    p = command(group, "retinanet-coco-test", retinanet_coco_test)
    p.add_argument("--imgs", required=True)
    p.add_argument("--annotations", required=True,
                   help="COCO instances_*.json")
    p.add_argument("--weights", default=None,
                   help="GLN checkpoint; random init if omitted (smoke "
                        "mode)")
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--coco-thresholds", dest="coco_sweep",
                   action="store_true")
    canvas_option(p)
