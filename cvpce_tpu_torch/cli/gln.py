"""`gln` command group; counterpart of cvpce_tpu/cli/gln.py.

Each command runs on the `device` that main() resolved from `--device`.
Weights options take a reference GaussianLayerNetwork checkpoint file,
the port's own GLN training checkpoint (`<out>/checkpoint`,
`<out>/epoch_<e>`), or a directory: a port training run (`<out>`) or a
serving export (pipeline/serving.py), read by
cli/common.py:load_gln_state_dict. The JAX package's orbax directories
raise (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import json
import os
from os import path

import numpy as np
import torch

from ..data import defaults
from ..models.gln import GLNConfig
from . import (Multiple, UsageError, canvas_option, command,
               existing_path)
from .common import default_gln_config, load_gln_state_dict

# hyperopt'd presets (cvpce/cli/gln.py:124-126)
HYPEROPT_LR_MULTIPLIER = 0.995
HYPEROPT_THRESHOLDS_TANH = (-1.0, 0.3)
HYPEROPT_THRESHOLDS_PLAIN = (0.0, 0.65)


def _nhwc(shape) -> tuple:
    """An NCHW shape in the JAX package's NHWC order."""
    n, c, h, w = shape
    return (n, h, w, c)


def build_assistant(canvas, device):
    """Shape-logging dry run of an untrained GLN (cvpce/cli/gln.py:29-57).

    Prints the JAX command's lines, feature maps in NHWC order."""
    from ..models.fpn import FPN
    from ..models.gln import GLN, postprocess_detections
    from ..models.resnet import ResNet50

    h, w = canvas
    config = GLNConfig(canvas_h=h, canvas_w=w)
    x = torch.zeros((1, h, w, 3), device=device)
    with torch.inference_mode():
        feats = ResNet50(norm="frozen").to(device).eval()(
            x.permute(0, 3, 1, 2))
        print(", ".join(f"{k}: {_nhwc(v.shape)}" for k, v in feats.items()))
        pyramid = FPN().to(device).eval()(feats["c3"], feats["c4"],
                                          feats["c5"])
        print(", ".join(f"P{i + 3}: {_nhwc(p.shape)}"
                        for i, p in enumerate(pyramid)))
        model = GLN(config, generator=torch.Generator().manual_seed(0))
        out = model.to(device)(x)
        print(f"cls_logits: {tuple(out['cls_logits'].shape)}, "
              f"bbox_regression: {tuple(out['bbox_regression'].shape)}, "
              f"gaussians: {tuple(out['gaussians'].shape)}")
        anchors, counts = config.anchors()
        print(f"anchors: {anchors.shape[0]} over levels {list(counts)}")
        res = postprocess_detections(
            out, torch.from_numpy(anchors).to(device), counts,
            torch.tensor([[h, w]], dtype=torch.float32, device=device),
            config)
    print(f"detections: {tuple(res['boxes'].shape)}")


def _dataset_options(parser) -> None:
    parser.add_argument("--imgs", default=defaults.SKU110K_IMG_DIR)
    parser.add_argument("--annotations",
                        default=defaults.SKU110K_ANNOTATION_FILE)


def train(imgs, annotations, evalimgs, evalannotations, out, load, resume,
          tanh, method, batch_size, epochs, gauss_loss_neg_thresh,
          gauss_loss_pos_thresh, hyperopt_params, grain, canvas,
          max_detections, nms_candidates, device):
    """Train GLN on SKU-110K (cvpce/cli/gln.py:59-133).

    The best model used `--tanh --method simple --hyperopt-params`.
    Checkpoints land in --out (`checkpoint`, `epoch_<e>`), which `gln
    eval --weights` reads."""
    from ..data.sku110k import SKU110KDataset
    from ..train.gln import GLNTrainConfig
    from ..train.loops import train_proposal_generator

    method_map = {"normal": "mvn", "kant": "kant", "simple": "simple"}
    model_cfg = GLNConfig(tanh=tanh, canvas_h=canvas[0], canvas_w=canvas[1],
                          detections_per_img=max_detections,
                          max_nms_candidates=nms_candidates)
    lr_multiplier = 0.99
    neg, pos = gauss_loss_neg_thresh, gauss_loss_pos_thresh
    if hyperopt_params:
        lr_multiplier = HYPEROPT_LR_MULTIPLIER
        neg, pos = (HYPEROPT_THRESHOLDS_TANH if tanh
                    else HYPEROPT_THRESHOLDS_PLAIN)
    train_cfg = GLNTrainConfig(
        lr_multiplier=lr_multiplier, negative_threshold=neg,
        positive_threshold=pos, gauss_method=method_map[method])
    dataset = SKU110KDataset(imgs, annotations, skip=defaults.SKU110K_SKIP,
                             canvas_h=model_cfg.canvas_h,
                             canvas_w=model_cfg.canvas_w)
    evalset = SKU110KDataset(
        evalimgs or imgs, evalannotations or annotations,
        skip=defaults.SKU110K_SKIP, flip_chance=0.0,
        canvas_h=model_cfg.canvas_h, canvas_w=model_cfg.canvas_w)
    kwargs = {}
    if grain:
        from ..data.grain_loader import GrainLoader

        kwargs["loader_cls"] = GrainLoader
    if load is not None and os.path.isdir(load):
        # a port run or serving export; an orbax directory raises
        kwargs["load_orbax"] = load
    else:
        kwargs["load_torch"] = load
    train_proposal_generator(
        dataset, evalset, out, model_cfg=model_cfg, train_cfg=train_cfg,
        batch_size=batch_size, epochs=epochs, resume=resume, device=device,
        **kwargs)


def load_eval_dataset(dataset_type, imgs, annotations, config, device):
    """The detection eval set of `gln eval` (cvpce/cli/gln.py
    _load_eval_dataset), its canvases made on `device`."""
    from ..data.sku110k import SKU110KDataset
    from ..eval.proposals import DetectionEvalAdapter

    if dataset_type == "sku110k":
        return SKU110KDataset(imgs, annotations,
                              skip=defaults.SKU110K_SKIP, flip_chance=0.0,
                              canvas_h=config.canvas_h,
                              canvas_w=config.canvas_w, device=device)
    if dataset_type == "gp180":
        from ..data.grocery import GroceryProductsTestSet

        base = GroceryProductsTestSet(imgs or defaults.GP_TEST_DIR,
                                      annotations or defaults.GP_ANN_DIR)
        return DetectionEvalAdapter(base, lambda it: (it[0], it[2]),
                                    config.canvas_h, config.canvas_w,
                                    device=device)
    if dataset_type == "gpbaseline":
        from ..data.grocery import GPBaselineDataset

        base = GPBaselineDataset(imgs, annotations
                                 or defaults.GP_BASELINE_ANN_FILE)
        return DetectionEvalAdapter(base, lambda it: (it[0], it[1]),
                                    config.canvas_h, config.canvas_w,
                                    device=device)
    raise UsageError(f"unknown dataset type {dataset_type}")


def eval_summary(res) -> dict:
    """`gln eval`'s JSON: each IoU threshold's metrics, curves dropped."""
    return {str(t): {k: float(v) for k, v in d.items() if k != "raw"}
            for t, d in res.items()}


def eval_cmd(imgs, annotations, weights, dataset_type, iou_thresholds,
             coco, batch_size, fast, canvas, max_detections, nms_candidates,
             out, plots, device):
    """Proposal AP/AR evaluation (cvpce/cli/gln.py:230-280).

    Prints each IoU threshold's metrics as JSON. --plots draws the P/R/F1
    curves with matplotlib, which is checked before any model is built."""
    import dataclasses

    from ..eval.proposals import evaluate_gln

    if plots:
        _require_matplotlib("--plots")
    config = dataclasses.replace(
        default_gln_config(fast), canvas_h=canvas[0], canvas_w=canvas[1],
        detections_per_img=max_detections, max_nms_candidates=nms_candidates)
    state_dict = load_gln_state_dict(weights, config)
    dataset = load_eval_dataset(dataset_type, imgs, annotations, config,
                                device)
    if coco:
        thresholds = tuple(np.arange(0.5, 1.0, 0.05).round(2))
    elif iou_thresholds:
        thresholds = tuple(iou_thresholds)
    else:
        thresholds = (0.5,)
    res = evaluate_gln(state_dict, dataset, config, thresholds=thresholds,
                       batch_size=batch_size, verbose=True, plot_out=plots,
                       device=device)
    summary = eval_summary(res)
    print(json.dumps(summary, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f)


def _require_matplotlib(option: str) -> None:
    from ..utils import viz

    if not viz.available():
        raise ModuleNotFoundError(
            f"{option} draws with matplotlib, which is not installed",
            name="matplotlib")


def detect(image, weights, threshold, fast, out, device):
    """Single-image detection (cvpce/cli/gln.py:282-307).

    --out draws the kept boxes with matplotlib, which is checked before
    the model is built."""
    from ..data import transforms as T
    from ..pipeline.calibrate import (calibration_dir_for_weights,
                                      resolve_input_norm)
    from ..pipeline.proposals import ProposalGenerator

    if out:
        _require_matplotlib("--out")
    config = default_gln_config(fast)
    state_dict = load_gln_state_dict(weights, config)
    gen = ProposalGenerator(
        state_dict, config, confidence_threshold=threshold,
        input_norm=resolve_input_norm(calibration_dir_for_weights(weights)),
        device=device)
    img = T.load_image(image)
    res = gen.detect(img)
    keep = res["valid"] & (res["scores"] > threshold)
    print(f"{int(keep.sum())} detections over {threshold}")
    for box, score in zip(res["boxes"][keep][:20], res["scores"][keep][:20]):
        print(f"  {score:.3f} {np.round(box, 1).tolist()}")
    if out:
        from ..utils import viz

        viz.save_boxes(img, res["boxes"][keep], out)
        print(f"saved {out}")


def seek_outliers(imgs, annotations, weights, sigmas, device):
    """Per-image loss outlier scan used to curate SKU110K_SKIP
    (cvpce/cli/gln.py:309-377).

    The per-image total loss of the model in eval mode, through the
    train step's loss function, with the JAX command's fixed GLNConfig()
    and GLNTrainConfig(). The JAX command pads each photo's boxes to 768
    for its jitted loss; padded boxes are invalid and change no loss, so
    the port takes the photo's own boxes (tests/test_torch_cli_gln.py
    holds the two equal)."""
    from ..data.sku110k import SKU110KDataset
    from ..models.gln import GLN
    from ..train.gln import (GLNTrainConfig, compute_losses,
                             render_heatmap_targets)

    config = GLNConfig()
    train_cfg = GLNTrainConfig()
    model = GLN(config)
    model.load_state_dict(load_gln_state_dict(weights, config))
    model.to(device).eval()
    dataset = SKU110KDataset(imgs, annotations, flip_chance=0.0,
                             canvas_h=config.canvas_h,
                             canvas_w=config.canvas_w)
    anchors = torch.from_numpy(config.anchors()[0]).to(device)

    @torch.inference_mode()
    def loss_of(item) -> float:
        boxes = torch.as_tensor(item["boxes"], dtype=torch.float32,
                                device=device)[None]
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=device)
        sizes = torch.from_numpy(item["image_size"][None]).to(device)
        outputs = model(torch.as_tensor(item["image"])[None].to(device))
        heat = render_heatmap_targets(boxes, valid, sizes, config,
                                      train_cfg)[..., None]
        losses = compute_losses(outputs, anchors, boxes, valid, heat,
                                config, train_cfg)
        return float(losses["classification"] + losses["bbox_regression"]
                     + losses["gaussian"])

    all_losses = []
    for i in range(len(dataset)):
        item = dataset[i]
        all_losses.append((loss_of(item), item["name"]))
        if i % 50 == 0:
            print(f"{i}/{len(dataset)}")
    values = np.array([loss for loss, _ in all_losses])
    thresh = values.mean() + sigmas * values.std()
    outliers = [(loss, n) for loss, n in all_losses if loss > thresh]
    print(f"mean {values.mean():.3f} std {values.std():.3f} "
          f"threshold {thresh:.3f}")
    for loss, n in sorted(outliers, reverse=True):
        print(f"  {loss:.3f}\t{n}")


def hyperopt(imgs, annotations, evalimgs, evalannotations, out, trials,
             max_epochs, resume, batch_size, canvas, shared_state, host_id,
             device):
    """Hyperparameter search over the reference's GLN space
    (cvpce/cli/gln.py:171-200) with ASHA early stopping and
    exploding-gradient tolerance (max_failures=2, cli/gln.py:215).

    One concurrent trial per card of this process (the CPU alone under
    --device cpu); the best config and metric go to
    <out>/hyperopt_result.json."""
    from ..data.sku110k import SKU110KDataset
    from ..train.gln import GLNTrainConfig
    from ..train.hyperopt import (GLN_SPACE, device_scope, run_search,
                                  run_search_multihost, trial_dir_allocator)
    from ..train.loops import train_proposal_generator

    os.makedirs(out, exist_ok=True)
    new_trial_dir = trial_dir_allocator(out)
    ch, cw = canvas
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])

    def train_one_epoch(config, epoch, carry, device=None):
        model_cfg = GLNConfig(
            tanh=config["tanh"], canvas_h=ch, canvas_w=cw,
            max_nms_candidates=min(5120, (ch // 8) * (cw // 8)),
            detections_per_img=min(1000, (ch // 8) * (cw // 8)))
        # threshold re-parameterization as in
        # proposals_training.py:62-67 (apply_hyperopt_config)
        tmin = -1.0 if config["tanh"] else 0.0
        tscale = 2.0 if config["tanh"] else 1.0
        low = tmin + config["gauss_loss_neg_thresh"] * tscale
        high = low + (1 - config["gauss_loss_neg_thresh"]) * tscale \
            * config["gauss_loss_pos_thresh"]
        train_cfg = GLNTrainConfig(
            lr_multiplier=config["multiplier"],
            scale_class=config["scale_class"],
            scale_gaussian=config["scale_gaussian"],
            negative_threshold=low, positive_threshold=high)
        dataset = SKU110KDataset(
            imgs, annotations, skip=defaults.SKU110K_SKIP,
            canvas_h=model_cfg.canvas_h, canvas_w=model_cfg.canvas_w)
        evalset = SKU110KDataset(
            evalimgs or imgs, evalannotations or annotations,
            skip=defaults.SKU110K_SKIP, flip_chance=0.0,
            canvas_h=model_cfg.canvas_h, canvas_w=model_cfg.canvas_w)
        metrics = {}

        def report(**kw):
            metrics.update(kw)

        if carry is None:  # first epoch of this trial: own working dir
            carry = new_trial_dir()
        # no mesh inside trials, so concurrent trials keep to their cards
        with device_scope(device if device.type == "cuda" else None):
            train_proposal_generator(
                dataset, evalset, carry, model_cfg=model_cfg,
                train_cfg=train_cfg, batch_size=batch_size, epochs=1,
                eval_interval=1, resume=epoch > 0, use_mesh=False,
                hyperopt_report=report, device=device)
        return metrics.get("average_precision", 0.0), carry

    if shared_state:
        result = run_search_multihost(
            train_one_epoch, GLN_SPACE, state_path=shared_state,
            num_trials=trials, max_epochs=max_epochs, devices=devices,
            host_id=host_id)
    else:
        result = run_search(
            train_one_epoch, GLN_SPACE, num_trials=trials,
            max_epochs=max_epochs, devices=devices,
            state_path=path.join(out, "search_state.json"), resume=resume)
    best = {"best_config": result["best_config"],
            "best_metric": result["best_metric"]}
    print(json.dumps(best, indent=2))
    with open(path.join(out, "hyperopt_result.json"), "w") as f:
        json.dump(best, f)


def register(commands) -> None:
    gln = commands.add_parser(
        "gln", help="Gaussian Layer Network: product proposal detection.",
        description="Gaussian Layer Network: product proposal detection.")
    group = gln.add_subparsers(dest="group_command", metavar="COMMAND",
                               required=True)

    p = command(group, "build-assistant", build_assistant)
    canvas_option(p)

    p = command(group, "train", train)
    _dataset_options(p)
    p.add_argument("--evalimgs", default=None)
    p.add_argument("--evalannotations", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--load", default=None,
                   help="starting point: a reference GLN checkpoint, a "
                        "port training checkpoint, or a port run or "
                        "serving-export directory")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tanh", action="store_true")
    p.add_argument("--method", choices=["normal", "kant", "simple"],
                   default="normal")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--gauss-loss-neg-thresh", type=float, default=0.0)
    p.add_argument("--gauss-loss-pos-thresh", type=float, default=0.1)
    p.add_argument("--hyperopt-params", action="store_true",
                   help="use the hyper-optimized params "
                        "(cli/gln.py:124-126)")
    p.add_argument("--grain", action="store_true",
                   help="GrainLoader input pipeline (mid-epoch "
                        "resumable)")
    canvas_option(p, "detector canvas (h w); static shapes replace the "
                     "reference's variable-size RetinaNet transform")
    p.add_argument("--max-detections", type=int, default=1000)
    p.add_argument("--nms-candidates", type=int, default=5120)

    p = command(group, "eval", eval_cmd)
    _dataset_options(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--dataset-type", choices=["sku110k", "gp180",
                                              "gpbaseline"],
                   default="sku110k")
    p.add_argument("--iou-threshold", dest="iou_thresholds",
                   action=Multiple, type=float, default=(),
                   help="IoU threshold(s); default 0.5")
    p.add_argument("--coco", action="store_true", help="IoU sweep 0.5:0.95")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--fast", action="store_true",
                   help="bf16 convs (exact top-k)")
    canvas_option(p)
    p.add_argument("--max-detections", type=int, default=1000,
                   help="detections kept per image (postprocess shape)")
    p.add_argument("--nms-candidates", type=int, default=5120,
                   help="NMS candidate budget across levels")
    p.add_argument("--out", default=None, help="write metrics JSON here")
    p.add_argument("--plots", default=None,
                   help="save P/R/F1 curve plots here (.png)")

    p = command(group, "detect", detect)
    p.add_argument("image", type=existing_path)
    p.add_argument("--weights", required=True)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--out", default=None, help="save visualization here")

    p = command(group, "seek-sku110k-outliers", seek_outliers)
    _dataset_options(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--sigmas", type=float, default=3.0)

    p = command(group, "hyperopt", hyperopt)
    _dataset_options(p)
    p.add_argument("--evalimgs", default=None)
    p.add_argument("--evalannotations", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--trials", type=int, default=16,
                   help="TOTAL trial budget (incl. restored on --resume)")
    p.add_argument("--max-epochs", type=int, default=9)
    p.add_argument("--resume", action="store_true",
                   help="restore search_state.json from --out and "
                        "continue (cvpce/cli/gln.py:212-213)")
    p.add_argument("--batch-size", type=int, default=1)
    canvas_option(p)
    p.add_argument("--shared-state", default=None,
                   help="multi-host search: claim trials from this "
                        "shared flock-backed store (the same command on "
                        "every host with a distinct --host-id)")
    p.add_argument("--host-id", type=int, default=0)
