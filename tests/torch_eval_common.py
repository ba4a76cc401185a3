"""Shared inputs of tests/test_torch_eval.py,
tests/test_torch_eval_compliance.py and tests/test_torch_orbax.py:
256x384 windows of synthetic planogram scenes, their detection and
test-set wrappers, the gallery, the trained artifacts/gln_r5 +
artifacts/dihe_r4 stack loaded into both packages (a module-scoped
fixture each eval file imports: JAX's side through JAX's orbax loaders,
the port's through its own reader), and one orbax restore of each export
a process (`jax_restore`, `port_restore`)."""
import functools
import os

import jax
import numpy as np
import pytest

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.data import transforms as j_T
from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.models.embedders import EmbedFn as JEmbedFn
from cvpce_tpu.models.embedders import fold_bn_variables as j_fold_bn
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.pipeline.classifier import Classifier as JClassifier
from cvpce_tpu.pipeline.proposals import ProposalGenerator as JProposals
from cvpce_tpu_torch.models.embedders import MACVGG, EmbedFn, fold_bn_variables
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.pipeline.classifier import Classifier
from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLN_DIR = os.path.join(REPO, "artifacts", "gln_r5")
DIHE_DIR = os.path.join(REPO, "artifacts", "dihe_r4")
H, W = 256, 384
THRESHOLD = 0.4837080240249634  # artifacts/gln_r5 serving_calibration.json
N_STYLES = 8
SEEDS = ((0, 0.0), (1, 0.4), (2, 0.4))
EXACT = ("ap", "ar_300", "f", "p", "r")
# scores from the image: the forward's f32 convolutions sum in another
# order than XLA's, which moves these windows' scores by up to 1.2e-6
# (ROADMAP Queue 3); on equal logits the sigmoids are one f32 ulp apart.
# The metrics' `c` and the calibrated threshold are such scores.
SCORE_TOL = 2e-6
# the JAX Classifier pads every batch to its size for jit: a window's
# crops fill about one batch of 8
J_BATCH = 8


def window(seed, violation_rate):
    """A 256x384 window of a full-size planogram scene (bottom shelf):
    the image, the planogram slots and the rendered products inside it,
    and the window's intact share."""
    styles = j_syn.product_styles(N_STYLES)
    img, plano, actual, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng((seed, 9)),
        violation_rate=violation_rate, min_shelves=4, max_shelves=4)
    y0, x0 = 832 - H - 8, 200
    off = np.array([x0, y0, x0, y0], np.float32)

    def inside(b):
        return ((b[:, 0] >= x0) & (b[:, 2] <= x0 + W)
                & (b[:, 1] >= y0) & (b[:, 3] <= y0 + H))

    pin, ain = inside(plano["boxes"]), inside(actual["boxes"])
    viol = [v for v, k in zip(plano["violations"], pin) if k]
    return {
        "image": np.ascontiguousarray(img[y0:y0 + H, x0:x0 + W]),
        "planogram": {"boxes": plano["boxes"][pin] - off,
                      "labels": [lb for lb, k in zip(plano["labels"], pin)
                                 if k]},
        "boxes": actual["boxes"][ain] - off,
        "labels": [lb for lb, k in zip(actual["labels"], ain) if k],
        "intact": viol.count("intact") / len(viol),
    }


class WindowDetSet:
    """The windows as SKU110K-shaped detection items (raw [0, 1] images
    at canvas size, scale 1)."""

    def __init__(self, windows):
        self.windows = windows

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, i):
        w = self.windows[i]
        return {"image": w["image"], "boxes": w["boxes"],
                "image_size": np.array([H, W], np.int32),
                "scale": np.float32(1.0), "orig_boxes": w["boxes"].copy()}


class WindowTestSet:
    """(img, anns, boxes) items with ann_to_int / int_to_ann over the
    styles (GroceryProductsTestSet contract)."""

    def __init__(self, windows):
        self.windows = windows
        self.int_to_ann = [f"prod_{i:02d}" for i in range(N_STYLES)]
        self.ann_to_int = {a: i for i, a in enumerate(self.int_to_ann)}

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, i):
        w = self.windows[i]
        return w["image"], w["labels"], w["boxes"]


def gallery():
    items = []
    for s in j_syn.product_styles(N_STYLES):
        img = j_T.scale_to_tanh(j_T.resize_for_classification(
            j_syn.product_gallery_image(s)))
        items.append((img, img, s["label"], s["label"]))
    return items


def export_dir(name: str) -> str:
    """The orbax directory of the export artifacts/<name>."""
    return os.path.join(REPO, "artifacts", name, "serving_checkpoint")


@functools.lru_cache(maxsize=None)
def jax_restore(name: str):
    """orbax's restore of artifacts/<name>, once a process."""
    from cvpce_tpu.pipeline.serving import _raw_restore

    return jax.device_get(_raw_restore(export_dir(name)))


@functools.lru_cache(maxsize=None)
def port_restore(name: str):
    """The port's restore of artifacts/<name>, once a process."""
    from cvpce_tpu_torch.utils.orbax_read import restore

    return restore(export_dir(name))


@pytest.fixture(scope="module")
def stack():
    from cvpce_tpu.pipeline.serving import (load_dihe_encoder,
                                            load_gln_variables)
    from cvpce_tpu_torch.pipeline import serving

    gln = jax.device_get(load_gln_variables(GLN_DIR))
    params, stats = jax.device_get(load_dihe_encoder(DIHE_DIR))
    j_enc = JEmbedFn(JMACVGG(batch_norm=False),
                     j_fold_bn({"params": params, "batch_stats": stats}))
    # the port's side reads the exports with its own orbax reader
    state = serving.load_gln_variables(GLN_DIR)
    vgg = MACVGG(batch_norm=True)
    vgg.load_state_dict(serving.load_dihe_encoder(DIHE_DIR))
    t_enc = EmbedFn(fold_bn_variables(vgg), device="cpu")
    items = gallery()
    j_pg = JProposals(gln, JGLNConfig(canvas_h=H, canvas_w=W),
                      confidence_threshold=THRESHOLD, input_norm="raw01")
    t_pg = ProposalGenerator(state, GLNConfig(canvas_h=H, canvas_w=W),
                             confidence_threshold=THRESHOLD,
                             input_norm="raw01", device="cpu")
    return {
        "gln": gln, "state": state,
        "j_enc": j_enc, "t_enc": t_enc, "gallery": items,
        "j_pg": j_pg, "t_pg": t_pg,
        "j_clf": JClassifier(j_enc, 1024, sample_set=items,
                             batch_size=J_BATCH),
        "t_clf": Classifier(t_enc, 1024, sample_set=items, device="cpu"),
        "windows": [window(s, v) for s, v in SEEDS],
        # the JAX ProposalGenerator's compiled batch-1 program serves
        # every JAX evaluation below
        "j_infer": lambda variables, images, sizes: j_pg._infer(
            images, sizes),
    }


def assert_metrics(got, want, c_tol=SCORE_TOL):
    assert list(got) == list(want)
    for t in want:
        for key in EXACT:
            assert got[t][key] == want[t][key], (t, key)
        assert got[t]["c"] == pytest.approx(want[t]["c"], abs=c_tol), t
