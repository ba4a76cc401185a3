#!/usr/bin/env python3
"""Measure how far the port's evaluation path lies from the JAX package's
on the CPU, on the inputs of tests/test_torch_colorcorrect.py and
tests/torch_eval_common.py (whose tests hold these differences to their
bounds):

- data/transforms.py:gaussian_blur against cv2.GaussianBlur;
- pipeline/colorcorrect.py:estimate_illumination_field against the JAX
  version (cv2's blur);
- data/synthetic.py:apply_domain_shift with a blur drawn, and
  ArchetypeGallerySet (the port's bilinear resize against cv2's);
- the trained GLN (artifacts/gln_r5) on the three 256x384 windows:
  detection scores and boxes;
- eval_dihe with the trained MACVGG (artifacts/dihe_r4): top-1 labels
  that differ between the JAX bf16 einsum crops and the port's f32
  gather crops, and both accuracies.

Prints one JSON object. Needs the JAX package, cv2 and the artifacts:

    JAX_PLATFORMS=cpu python scripts/torch_eval_parity.py
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
H, W = 256, 384
THRESHOLD = 0.4837080240249634  # artifacts/gln_r5 serving_calibration.json
N_STYLES = 8


def max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def window(j_syn, seed, violation_rate):
    styles = j_syn.product_styles(N_STYLES)
    img, _, actual, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng((seed, 9)),
        violation_rate=violation_rate, min_shelves=4, max_shelves=4)
    y0, x0 = 832 - H - 8, 200
    b = actual["boxes"]
    ain = ((b[:, 0] >= x0) & (b[:, 2] <= x0 + W)
           & (b[:, 1] >= y0) & (b[:, 3] <= y0 + H))
    return (np.ascontiguousarray(img[y0:y0 + H, x0:x0 + W]),
            [lb for lb, k in zip(actual["labels"], ain) if k],
            b[ain] - np.array([x0, y0, x0, y0], np.float32))


def main():
    import cv2
    import jax
    import jax.numpy as jnp
    import torch

    from cvpce_tpu.data import synthetic as j_syn
    from cvpce_tpu.data import transforms as j_T
    from cvpce_tpu.models.embedders import MACVGG as JMACVGG
    from cvpce_tpu.models.embedders import EmbedFn as JEmbedFn
    from cvpce_tpu.models.embedders import fold_bn_variables as j_fold_bn
    from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
    from cvpce_tpu.ops.image import crop_resize_square_mxu
    from cvpce_tpu.pipeline import colorcorrect as j_cc
    from cvpce_tpu.pipeline.classifier import Classifier as JClassifier
    from cvpce_tpu.pipeline.proposals import ProposalGenerator as JProposals
    from cvpce_tpu.pipeline.serving import (load_dihe_encoder,
                                            load_gln_variables)
    from cvpce_tpu_torch.data import synthetic as syn
    from cvpce_tpu_torch.data import transforms as T
    from cvpce_tpu_torch.models.embedders import (MACVGG, EmbedFn,
                                                  fold_bn_variables)
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.ops.image import crop_resize_square
    from cvpce_tpu_torch.pipeline import colorcorrect as cc
    from cvpce_tpu_torch.pipeline.classifier import Classifier
    from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator
    from cvpce_tpu_torch.utils.weights import (gln_state_dict,
                                               macvgg_state_dict)

    out = {}
    rng = np.random.default_rng(0)
    blur = {}
    for shape, sigma in (((256, 384), 30.72), ((32, 400), 3.84),
                         ((5, 7, 3), 1.1), ((832, 1344), 99.84)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        blur[f"{shape} sigma {sigma}"] = max_diff(
            T.gaussian_blur(img, sigma),
            cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma))
    out["gaussian_blur_vs_cv2"] = blur

    scene = rng.uniform(0, 1, (256, 384, 3)).astype(np.float32)
    out["illumination_field_256x384"] = max_diff(
        cc.estimate_illumination_field(scene),
        j_cc.estimate_illumination_field(scene))
    out["apply_domain_shift_72x100_strength_0.7"] = max(
        max_diff(syn.apply_domain_shift(scene[:72, :100], np.random
                                        .default_rng(s), 0.7),
                 j_syn.apply_domain_shift(scene[:72, :100], np.random
                                          .default_rng(s), 0.7))
        for s in range(4))
    g = syn.ArchetypeGallerySet(syn.product_styles(6), views=3, seed=9)
    jg = j_syn.ArchetypeGallerySet(j_syn.product_styles(6), views=3, seed=9)
    out["archetype_gallery_set"] = max(max_diff(g[i][0], jg[i][0])
                                       for i in range(len(g)))

    gln = jax.device_get(load_gln_variables(
        os.path.join(REPO, "artifacts", "gln_r5")))
    params, stats = jax.device_get(load_dihe_encoder(
        os.path.join(REPO, "artifacts", "dihe_r4")))
    j_pg = JProposals(gln, JGLNConfig(canvas_h=H, canvas_w=W),
                      confidence_threshold=THRESHOLD, input_norm="raw01")
    t_pg = ProposalGenerator(gln_state_dict(gln),
                             GLNConfig(canvas_h=H, canvas_w=W),
                             confidence_threshold=THRESHOLD,
                             input_norm="raw01", device="cpu")
    windows = [window(j_syn, s, v) for s, v in ((0, 0.0), (1, 0.4),
                                                (2, 0.4))]
    scores, boxes = [], []
    for img, _, _ in windows:
        a, b = t_pg.detect(img), j_pg.detect(img)
        scores.append(max_diff(a["scores"], b["scores"]))
        boxes.append(max_diff(a["boxes"], b["boxes"]))
    out["detect_scores_per_window"] = scores
    out["detect_boxes_px_per_window"] = boxes

    items = []
    for s in j_syn.product_styles(N_STYLES):
        img = j_T.scale_to_tanh(j_T.resize_for_classification(
            j_syn.product_gallery_image(s)))
        items.append((img, img, s["label"], s["label"]))
    j_clf = JClassifier(JEmbedFn(JMACVGG(batch_norm=False), j_fold_bn(
        {"params": params, "batch_stats": stats})), 1024, sample_set=items)
    vgg = MACVGG(batch_norm=True)
    vgg.load_state_dict(macvgg_state_dict(params, stats))
    t_clf = Classifier(EmbedFn(fold_bn_variables(vgg), device="cpu"), 1024,
                       sample_set=items, device="cpu")
    flips = total = j_right = t_right = 0
    for img, labels, bx in windows:
        j_crops = np.asarray(crop_resize_square_mxu(
            jnp.asarray(img), jnp.asarray(bx))) * 2.0 - 1.0
        t_crops = crop_resize_square(torch.from_numpy(img),
                                     torch.from_numpy(bx)) * 2.0 - 1.0
        j_top = [r[0] for r in j_clf.classify(j_crops)]
        t_top = [r[0] for r in t_clf.classify(t_crops)]
        flips += sum(a != b for a, b in zip(j_top, t_top))
        j_right += sum(a == b for a, b in zip(j_top, labels))
        t_right += sum(a == b for a, b in zip(t_top, labels))
        total += len(labels)
    out["eval_dihe"] = {"crops": total, "top1_flips": flips,
                        "jax_top1": j_right / total,
                        "port_top1": t_right / total}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
