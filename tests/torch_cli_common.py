"""Inputs shared by tests/test_torch_cli_gln.py and
tests/test_torch_cli_eval.py: weights files that both packages' loaders
read, and small datasets in their own layouts, PNG bytes under the
datasets' `.jpg` names (both decoders go by the signature).

- `gln.pth`: a reference GaussianLayerNetwork checkpoint
  (testing.gln_reference_state_dict) with torchvision RetinaNet's focal
  prior (0.01) on the classification bias, so that detections clear the
  0.05 postprocess floor without swamping it;
- `vgg.pth`: torchvision vgg16_bn `features.*`
  (testing.vgg16_features_state_dict);
- `sku/`: SKU-110K photos and their CSV;
- `gp/Training/<category>/<sub>/<n>.jpg`: a Grocery Products gallery of
  textured products on white; `gp/test/` the GP-180 layout (store
  scenes with the products pasted at a Tonioni planogram's grid,
  annotation CSVs, planogram JSONs);
- `internal/`: an internal planoset (index.json, code/box planograms);
- `folder/`: a pipeline-demo gallery folder and a JSON planogram;
- `coco/`: the SKU photos under a COCO `instances` JSON.

The scenes are made of the gallery's own products, so the random
embedder's nearest product is often the right one; what the random
detector finds among them is whatever it finds.
"""
import contextlib
import dataclasses
import functools
import json
import math
from pathlib import Path

import numpy as np
import torch

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.testing import write_png

CANVAS = 64
# detections and NMS candidates at CANVAS (the JAX CLI tests' sizes)
MAX_DETECTIONS = 64
NMS_CANDIDATES = 128
PRODUCTS = (("Food", "Bakery", "1"), ("Food", "Bakery", "2"),
            ("Food", "Dairy", "1"), ("Drinks", "Juice", "1"))
PRODUCT_HW = (36, 28)
SKU_PHOTOS = 4


def _product(rng, hw=PRODUCT_HW) -> np.ndarray:
    """A textured product on a white margin: blocks of a few colours."""
    h, w = hw
    img = np.full((h, w, 3), 255, np.uint8)
    cells = rng.integers(0, 220, (4, 3, 3))
    body = np.repeat(np.repeat(cells, -(-(h - 4) // 4), 0),
                     -(-(w - 4) // 3), 1)[:h - 4, :w - 4]
    img[2:-2, 2:-2] = body
    return img.astype(np.uint8)


def _grid(rows: int, cols: int, ogg) -> dict:
    """A Tonioni planogram grid (n/s/e/w neighbours, -1 for none)."""
    graph = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            graph.append({"ogg": int(ogg[i]),
                          "n": i - cols if r else -1,
                          "s": i + cols if r < rows - 1 else -1,
                          "e": i + 1 if c < cols - 1 else -1,
                          "w": i - 1 if c else -1})
    objects = [{"width": float(PRODUCT_HW[1]), "height": float(PRODUCT_HW[0]),
                "img_path": "/".join(p) + ".jpg"} for p in PRODUCTS]
    return {"graph": graph, "objects": objects}


def _scene(products, layout, rows, cols, rng, pad=6):
    """Products pasted on a grey shelf in a rows x cols grid; returns the
    image and each slot's box (x1, y1, x2, y2)."""
    ph, pw = PRODUCT_HW
    h, w = rows * (ph + pad) + pad, cols * (pw + pad) + pad
    img = np.full((h, w, 3), 128, np.uint8)
    img += rng.integers(0, 20, img.shape, dtype=np.uint8)
    boxes = []
    for i, p in enumerate(layout):
        r, c = divmod(i, cols)
        y, x = pad + r * (ph + pad), pad + c * (pw + pad)
        img[y:y + ph, x:x + pw] = products[p]
        boxes.append([x, y, x + pw, y + ph])
    return img, boxes


def write_inputs(root: Path, seed: int = 0) -> dict:
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = {"root": str(root)}

    sd = testing.gln_reference_state_dict(np.random.default_rng(seed + 1))
    sd["head.classification_head.cls_logits.bias"].fill_(
        -math.log((1 - 0.01) / 0.01))
    torch.save(sd, root / "gln.pth")
    out["gln"] = str(root / "gln.pth")
    torch.save(testing.vgg16_features_state_dict(
        np.random.default_rng(seed + 2)), root / "vgg.pth")
    out["vgg"] = str(root / "vgg.pth")

    products = [_product(rng) for _ in PRODUCTS]
    train = root / "gp" / "Training"
    for (cat, sub, name), img in zip(PRODUCTS, products):
        (train / cat / sub).mkdir(parents=True, exist_ok=True)
        write_png(train / cat / sub / f"{name}.jpg", img)
    out["source"] = str(train)
    labels = ["/".join(p) for p in PRODUCTS]

    # GP-180: a scene of a planogram grid with two slots swapped (their
    # products do not comply)
    test = root / "gp" / "test"
    (test / "ann").mkdir(parents=True)
    (test / "planos").mkdir()
    rows, cols = 2, 3
    plan = [0, 1, 2, 3, 1, 0]
    for store, image, layout in (("1", "1", [2, 1, 0, 3, 1, 0]),):
        img, boxes = _scene(products, layout, rows, cols, rng)
        d = test / "imgs" / f"store{store}" / "images"
        d.mkdir(parents=True, exist_ok=True)
        write_png(d / f"store{store}_{image}.jpg", img)
        (test / "ann" / f"s{store}_{image}.csv").write_text("".join(
            f"{labels[p]}.jpg, {b[0]}, {b[1]}, {b[2]}, {b[3]}\n"
            for p, b in zip(layout, boxes)))
        (test / "planos" / f"s{store}_{image}.json").write_text(
            json.dumps(_grid(rows, cols, plan)))
    out.update(test_imgs=str(test / "imgs"), test_ann=str(test / "ann"),
               planos=str(test / "planos"))

    # internal planoset: the same shelf, codes and boxes (y up)
    internal = root / "internal"
    internal.mkdir()
    index = []
    for k, layout in enumerate((plan, [0, 1, 3, 3, 1, 0])):
        img, boxes = _scene(products, layout, rows, cols, rng)
        write_png(internal / f"shelf{k}.jpg", img)
        top = img.shape[0]
        plano = [{"code": labels[p], "box": [b[0], top - b[3], b[2],
                                             top - b[1]]}
                 for p, b in zip(plan, boxes)]
        (internal / f"plano{k}.json").write_text(json.dumps(plano))
        correct = sum(a == b for a, b in zip(plan, layout))
        index.append({"image": f"shelf{k}.jpg", "planogram":
                      f"plano{k}.json", "correct": correct,
                      "facings": len(plan)})
    (internal / "index.json").write_text(json.dumps(index))
    out["internal"] = str(internal)

    # pipeline-demo: one image per product named by its label
    folder = root / "folder"
    folder.mkdir()
    for p, img in enumerate(products):
        write_png(folder / f"p{p}.png", img)
    img, boxes = _scene(products, plan, rows, cols, rng)
    write_png(root / "demo_scene.png", img)
    (root / "demo_plano.json").write_text(json.dumps(
        [{"label": f"p{p}", "box": b} for p, b in zip(plan, boxes)]))
    out.update(folder=str(folder), demo_scene=str(root / "demo_scene.png"),
               demo_plano=str(root / "demo_plano.json"))

    # SKU-110K photos of CANVAS x CANVAS (scale 1 onto the canvas): a
    # shelf scene cut to size, annotated with a seeded dozen of the
    # canvas's anchors that lie inside it, so that some detections (near
    # their anchors) match and the metrics are not all 0
    anchors = GLNConfig(canvas_h=CANVAS, canvas_w=CANVAS).anchors()[0]
    inside = anchors[(anchors >= 0).all(1) & (anchors <= CANVAS).all(1)]
    sku = root / "sku"
    (sku / "images").mkdir(parents=True)
    rows_csv, coco_images, coco_anns = [], [], []
    for k in range(SKU_PHOTOS):
        layout = rng.integers(0, len(products), 6)
        img = _scene(products, layout, rows, cols, rng)[0][:CANVAS, :CANVAS]
        name = f"train_{k}.jpg"
        write_png(sku / "images" / name, np.ascontiguousarray(img))
        picked = inside[rng.choice(len(inside), 12, replace=False)]
        for b in np.round(picked).astype(int).tolist():
            rows_csv.append(f"{name},{b[0]},{b[1]},{b[2]},{b[3]},object,"
                            f"{CANVAS},{CANVAS}")
            coco_anns.append({"image_id": 10 + k, "category_id": 1,
                              "bbox": [b[0], b[1], b[2] - b[0],
                                       b[3] - b[1]]})
        coco_images.append({"id": 10 + k, "file_name": name,
                            "width": CANVAS, "height": CANVAS})
    (sku / "ann.csv").write_text("\n".join(rows_csv) + "\n")
    out.update(sku_imgs=str(sku / "images"), sku_ann=str(sku / "ann.csv"))
    (root / "instances.json").write_text(json.dumps({
        "images": coco_images, "annotations": coco_anns,
        "categories": [{"id": 1, "name": "object"}]}))
    out["coco_ann"] = str(root / "instances.json")
    return out


def canvas_args() -> list:
    return ["--canvas", str(CANVAS), str(CANVAS)]


def small_args() -> list:
    return canvas_args() + ["--max-detections", str(MAX_DETECTIONS),
                            "--nms-candidates", str(NMS_CANDIDATES)]


def json_of(text: str):
    """The JSON object that a command printed last (after its progress
    lines)."""
    start = 0 if text.startswith("{") else text.index("\n{") + 1
    return json.loads(text[start:])


@contextlib.contextmanager
def jax_models_built_once():
    """Within the block, the JAX CLI's commands share one GLN variables
    tree per (weights, config but its postprocess caps), one embedder per
    (weights, int8), one
    gallery index per (embedder, gallery files) and one jitted detector
    per (variables, config, serving options): each is a pure function of
    those, and building it (flax's op-by-op init, a ResNet-50 trace and
    compile, the index's embedding in batches padded to 32) is the bulk
    of a command's time on the CPU."""
    from unittest import mock

    from cvpce_tpu.cli import common, eval as j_eval, gln as j_gln
    from cvpce_tpu.cli import misc as j_misc
    from cvpce_tpu.eval import proposals as j_eval_proposals
    from cvpce_tpu.pipeline import proposals as j_proposals
    from cvpce_tpu.pipeline.classifier import Classifier

    @functools.lru_cache(maxsize=None)
    def variables(weights, config):
        return common.load_gln_variables(weights, config)

    def gln(weights, config):
        # the tree does not depend on the postprocess caps (conv shapes)
        return variables(weights, dataclasses.replace(
            config, max_nms_candidates=0, detections_per_img=0))

    @functools.lru_cache(maxsize=None)
    def embedder_of(weights, int8):
        return common.load_embedder(weights, int8=int8)

    def embedder(weights, int8=False):
        return embedder_of(weights, int8)

    build_index = Classifier.build_index
    indexes = {}

    def index_once(self, sample_set, verbose=False):
        paths = getattr(sample_set, "paths", None)
        if paths is None:  # pipeline-demo's wrapped folder set
            return build_index(self, sample_set, verbose)
        key = (id(self.encoder_fn), tuple(paths))
        if key not in indexes:
            indexes[key] = build_index(self, sample_set, verbose)
        return indexes[key]

    detector, detectors = j_proposals.ProposalGenerator, {}

    def detector_once(variables, config, **kw):
        key = (id(variables), config, tuple(sorted(kw.items())))
        if key not in detectors:
            detectors[key] = detector(variables, config, **kw)
        return detectors[key]

    make_inference_fn, inference = j_eval_proposals.make_inference_fn, {}

    def inference_once(variables, config):
        key = (id(variables), config)
        if key not in inference:
            inference[key] = make_inference_fn(variables, config)
        return inference[key]

    with contextlib.ExitStack() as stack:
        for module in (j_eval, j_gln, j_misc):
            stack.enter_context(mock.patch.object(
                module, "load_gln_variables", gln))
        for module in (j_eval, j_misc):
            stack.enter_context(mock.patch.object(
                module, "load_embedder", embedder))
        stack.enter_context(mock.patch.object(Classifier, "build_index",
                                              index_once))
        stack.enter_context(mock.patch.object(
            j_proposals, "ProposalGenerator", detector_once))
        stack.enter_context(mock.patch.object(
            j_eval_proposals, "make_inference_fn", inference_once))
        yield
