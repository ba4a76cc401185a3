"""Deterministic synthetic shelf scenes, planogram scenes and product
gallery renders.

numpy copy of cvpce_tpu/data/synthetic.py: the detection sets
(`shelf_scene`, `SyntheticShelfDataset`, `PlanogramSceneDetectionSet`),
the planogram scenes and their photometric domain shift
(`planogram_scene`, `apply_domain_shift`), and the DIHE gallery and
query sets (`ArchetypeGallerySet`, `PlanogramQuerySet`). The same
(seed, arguments) draw the same numbers in the same order and give the
same arrays as the JAX package's functions; the defocus blur is
`transforms.gaussian_blur` (cv2's rules, f32 rounding apart) and the
gallery resize the port's bilinear one. The perspective warp
(`perspective_scene`, a cv2 warp) is not ported yet: `perspective > 0`
raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from . import transforms as T


def _no_perspective(perspective: float) -> None:
    if perspective > 0:
        raise NotImplementedError(
            "perspective > 0 needs perspective_scene (a cv2 warp), which "
            "is not ported yet (ROADMAP.md Queue 1)")


def _cached_item(store: dict, i: int, render) -> Dict:
    """Memoize a deterministic per-index detection item; box arrays are
    returned as fresh copies."""
    if i not in store:
        store[i] = render()
    item = dict(store[i])
    item["boxes"] = item["boxes"].copy()
    item["orig_boxes"] = item["orig_boxes"].copy()
    return item


def shelf_scene(h: int, w: int, rng: np.random.Generator,
                min_shelves: int = 4, max_shelves: int = 8,
                fill: float = 0.92) -> Tuple[np.ndarray, np.ndarray]:
    """Render one shelf scene. Returns (image [h,w,3] float32 in [0,1],
    boxes [n,4] float32 xyxy)."""
    img = np.empty((h, w, 3), np.float32)
    base = rng.uniform(0.25, 0.5)
    grad = np.linspace(base, base + rng.uniform(-0.1, 0.1), h,
                       dtype=np.float32)
    img[:] = grad[:, None, None]
    img += rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)

    n_shelves = int(rng.integers(min_shelves, max_shelves + 1))
    edges = np.linspace(0, h, n_shelves + 1).astype(int)
    boxes = []
    for s in range(n_shelves):
        top, bottom = edges[s], edges[s + 1]
        shelf_h = bottom - top
        board = max(2, shelf_h // 12)
        img[bottom - board:bottom] = rng.uniform(0.1, 0.2)
        x = int(rng.integers(0, max(1, w // 40)))
        row_h = shelf_h - board
        while x < w - 8:
            pw = int(rng.uniform(0.02, 0.07) * w)
            pw = max(6, min(pw, w - x - 1))
            ph = int(rng.uniform(0.65, 0.95) * row_h)
            ph = max(6, ph)
            y2 = bottom - board
            y1 = y2 - ph
            if rng.random() < fill:
                color = rng.uniform(0.15, 0.95, 3).astype(np.float32)
                img[y1:y2, x:x + pw] = color
                b = max(1, pw // 12)
                img[y1:y1 + b, x:x + pw] *= 0.5
                img[y2 - b:y2, x:x + pw] *= 0.5
                img[y1:y2, x:x + b] *= 0.5
                img[y1:y2, x + pw - b:x + pw] *= 0.5
                if rng.random() < 0.7:
                    band_y = y1 + int(0.3 * ph)
                    band_h = max(1, ph // 5)
                    img[band_y:band_y + band_h, x + b:x + pw - b] = \
                        rng.uniform(0.1, 0.9, 3).astype(np.float32)
                boxes.append([x, y1, x + pw, y2])
            x += pw + int(rng.integers(1, max(2, w // 100)))
    img = np.clip(img, 0.0, 1.0)
    if not boxes:
        boxes = [[0, 0, 8, 8]]
    return img, np.asarray(boxes, np.float32)


def _augment_scene(img: np.ndarray, boxes: np.ndarray,
                   rng: np.random.Generator, domain_shift: float,
                   perspective: float):
    """Deployment-domain augmentation for detector sets: each scene
    draws its shift strength uniformly in [0, domain_shift]."""
    _no_perspective(perspective)
    if domain_shift > 0:
        img = apply_domain_shift(img, rng,
                                 float(rng.uniform(0, domain_shift)))
    return img, boxes


def _detection_item(img, boxes, h: int, w: int, name: str) -> Dict:
    return {
        "image": img,
        "boxes": boxes,
        "image_size": np.array([h, w], np.int32),
        "scale": np.float32(1.0),
        "name": name,
        "orig_boxes": boxes.copy(),
        "orig_size": np.array([h, w], np.int32),
    }


class SyntheticShelfDataset:
    """SKU110K-shaped items (image/boxes/image_size/scale/orig_boxes)
    rendered directly at canvas size (scale=1), for evaluate_gln."""

    def __init__(self, n: int, canvas_h: int = 832, canvas_w: int = 1344,
                 seed: int = 0, min_shelves: int = 4, max_shelves: int = 8,
                 domain_shift: float = 0.0, perspective: float = 0.0):
        _no_perspective(perspective)
        self.n = n
        self.canvas_h = canvas_h
        self.canvas_w = canvas_w
        self.seed = seed
        self.min_shelves = min_shelves
        self.max_shelves = max_shelves
        self.domain_shift = domain_shift
        self.perspective = perspective
        self._items: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict:
        if not 0 <= i < self.n:
            raise IndexError(i)
        return _cached_item(self._items, i, lambda: self._render(i))

    def _render(self, i: int) -> Dict:
        rng = np.random.default_rng((self.seed, i))
        img, boxes = shelf_scene(self.canvas_h, self.canvas_w, rng,
                                 self.min_shelves, self.max_shelves)
        img, boxes = _augment_scene(img, boxes, rng, self.domain_shift,
                                    self.perspective)
        return _detection_item(img, boxes, self.canvas_h, self.canvas_w,
                               f"synthetic_{i}")


def product_styles(k: int, seed: int = 0, texture: bool = False):
    """k product archetypes with well-separated hues. Deterministic in
    (k, seed, texture). Style fields mirror the shelf-scene product recipe
    (solid base, darker border, stripe band).

    texture=True additionally gives each archetype a deterministic
    luminance pattern (stripe/checker kind, spatial frequency in cycles
    per product, phase) in normalized product coordinates, so identity
    is carried by texture as well as by colour."""
    import colorsys

    rng = np.random.default_rng(seed)
    kinds = ("hstripe", "vstripe", "diag", "checker")
    styles = []
    for i in range(k):
        hue = (i / k + rng.uniform(0, 0.5 / k)) % 1.0
        sat = float(rng.uniform(0.55, 0.9))
        val = float(rng.uniform(0.55, 0.95))
        color = np.asarray(colorsys.hsv_to_rgb(hue, sat, val), np.float32)
        band_hue = (hue + 0.5) % 1.0
        band = np.asarray(
            colorsys.hsv_to_rgb(band_hue, float(rng.uniform(0.4, 0.9)),
                                float(rng.uniform(0.3, 0.9))), np.float32)
        style = {
            "label": f"prod_{i:02d}",
            "color": color,
            "band_color": band,
            "band_frac": float(rng.uniform(0.2, 0.45)),
            "width_frac": float(rng.uniform(0.025, 0.06)),
            "height_frac": float(rng.uniform(0.7, 0.92)),
        }
        if texture:
            style["texture"] = {
                "kind": kinds[i % len(kinds)],
                "freq": 2.0 + (i // len(kinds)) % 5
                + float(rng.uniform(0.0, 0.4)),
                "phase": float(rng.uniform(0.0, 1.0)),
                "contrast": float(rng.uniform(0.3, 0.55)),
            }
        styles.append(style)
    return styles


def _texture_field(tex, ph: int, pw: int) -> np.ndarray:
    """(ph, pw) luminance-modulation field in [1 - contrast, 1] for a
    texture spec, in normalized product coordinates (so the gallery
    render and every in-scene instance show the same pattern regardless
    of pixel size)."""
    yy = (np.arange(ph, dtype=np.float32) + 0.5) / max(1, ph)
    xx = (np.arange(pw, dtype=np.float32) + 0.5) / max(1, pw)
    f, phase = tex["freq"], tex["phase"]
    two_pi = 2.0 * np.pi
    if tex["kind"] == "hstripe":
        wave = np.sign(np.sin(two_pi * (f * yy + phase)))[:, None]
        wave = np.broadcast_to(wave, (ph, pw))
    elif tex["kind"] == "vstripe":
        wave = np.sign(np.sin(two_pi * (f * xx + phase)))[None, :]
        wave = np.broadcast_to(wave, (ph, pw))
    elif tex["kind"] == "diag":
        u = 0.5 * yy[:, None] + 0.5 * xx[None, :]
        wave = np.sign(np.sin(two_pi * (f * u + phase)))
    else:  # checker
        sy = np.sign(np.sin(two_pi * (f * yy + phase)))
        sx = np.sign(np.sin(two_pi * (f * xx + phase)))
        wave = sy[:, None] * sx[None, :]
    return (1.0 - tex["contrast"] * 0.5 * (wave + 1.0)).astype(np.float32)


def _paint_product(img: np.ndarray, style, x: int, y1: int, y2: int,
                   pw: int, rng: np.random.Generator) -> None:
    """Draw one product instance into img (shelf_scene recipe: solid
    base, darker border, stripe band) with mild per-instance lighting
    jitter."""
    gain = rng.uniform(0.9, 1.1)
    color = np.clip(style["color"] * gain, 0.05, 1.0)
    img[y1:y2, x:x + pw] = color
    b = max(1, pw // 12)
    img[y1:y1 + b, x:x + pw] *= 0.5
    img[y2 - b:y2, x:x + pw] *= 0.5
    img[y1:y2, x:x + b] *= 0.5
    img[y1:y2, x + pw - b:x + pw] *= 0.5
    ph = y2 - y1
    band_y = y1 + int(style["band_frac"] * ph)
    band_h = max(1, ph // 5)
    img[band_y:band_y + band_h, x + b:x + pw - b] = np.clip(
        style["band_color"] * gain, 0.05, 1.0)
    tex = style.get("texture")
    if tex is not None:
        # archetype-identifying luminance pattern over the whole face
        # (base, border and band alike — multiplicative, so it survives
        # color casts that scale all stripes together)
        img[y1:y2, x:x + pw] *= _texture_field(tex, ph, pw)[..., None]


def product_gallery_image(style, height: int = 192) -> np.ndarray:
    """Canonical (no-jitter) render of one archetype at its in-scene
    aspect, float32 [0,1] (height, width, 3) — gallery source for the
    Classifier index (stand-in for GroceryProductsDataset entries)."""
    aspect = style["width_frac"] * 320.0 / (style["height_frac"] * 52.0)
    width = max(12, int(round(height * aspect)))
    img = np.full((height + 8, width + 8, 3), 0.35, np.float32)
    _paint_product(img, style, 4, 4, height + 4, width,
                   np.random.default_rng(12345))
    return np.clip(img, 0.0, 1.0)


def planogram_scene(h: int, w: int, styles, rng: np.random.Generator,
                    violation_rate: float = 0.0,
                    min_shelves: int = 3, max_shelves: int = 5,
                    fill: float = 0.92, domain_shift: float = 0.0):
    """Render a planogram-driven shelf scene.

    Returns (img, planogram, actual, expected_compliance) where
    planogram = {"boxes", "labels", "violations"} is the INTENDED
    layout ("violations": per-slot "intact"/"removed"/"swapped", for
    error attribution), actual = {"boxes", "labels"} the rendered
    ground truth (violations applied: 'removed' products absent,
    'swapped' rendered as another archetype), and expected_compliance
    = intact / planned. `domain_shift` > 0 applies the photometric
    deployment-domain shift (apply_domain_shift) after rendering.
    """
    img = np.empty((h, w, 3), np.float32)
    base = rng.uniform(0.25, 0.5)
    grad = np.linspace(base, base + rng.uniform(-0.1, 0.1), h,
                       dtype=np.float32)
    img[:] = grad[:, None, None]
    img += rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)

    n_shelves = int(rng.integers(min_shelves, max_shelves + 1))
    edges = np.linspace(0, h, n_shelves + 1).astype(int)
    plano_boxes, plano_labels, plano_viol = [], [], []
    act_boxes, act_labels = [], []
    intact = 0
    for s in range(n_shelves):
        top, bottom = edges[s], edges[s + 1]
        shelf_h = bottom - top
        board = max(2, shelf_h // 12)
        img[bottom - board:bottom] = rng.uniform(0.1, 0.2)
        row_h = shelf_h - board
        x = int(rng.integers(0, max(1, w // 40)))
        while x < w - 12:
            pid = int(rng.integers(0, len(styles)))
            style = styles[pid]
            pw = max(8, min(int(style["width_frac"] * w), w - x - 1))
            ph = max(8, int(style["height_frac"] * row_h))
            y2 = bottom - board
            y1 = y2 - ph
            if rng.random() < fill:
                plano_boxes.append([x, y1, x + pw, y2])
                plano_labels.append(style["label"])
                violated = rng.random() < violation_rate
                if not violated:
                    _paint_product(img, style, x, y1, y2, pw, rng)
                    act_boxes.append([x, y1, x + pw, y2])
                    act_labels.append(style["label"])
                    intact += 1
                    plano_viol.append("intact")
                elif rng.random() < 0.5:
                    plano_viol.append("removed")  # background shows
                else:
                    # swapped: another archetype at the same slot
                    other = styles[(pid + 1 + int(rng.integers(
                        0, len(styles) - 1))) % len(styles)]
                    _paint_product(img, other, x, y1, y2, pw, rng)
                    act_boxes.append([x, y1, x + pw, y2])
                    act_labels.append(other["label"])
                    plano_viol.append("swapped")
            x += pw + int(rng.integers(2, max(3, w // 80)))
    img = np.clip(img, 0.0, 1.0)
    img = apply_domain_shift(img, rng, domain_shift)
    planogram = {
        "boxes": np.asarray(plano_boxes, np.float32).reshape(-1, 4),
        "labels": plano_labels,
        "violations": plano_viol,
    }
    actual = {
        "boxes": np.asarray(act_boxes, np.float32).reshape(-1, 4),
        "labels": act_labels,
    }
    expected = intact / max(1, len(plano_labels))
    return img, planogram, actual, expected


class PlanogramSceneDetectionSet:
    """planogram_scene renders as SKU110K-shaped detection items: odd
    indices carry violations, `boxes` is the rendered ground truth."""

    def __init__(self, n: int, canvas_h: int = 832, canvas_w: int = 1344,
                 seed: int = 0, n_styles: int = 12,
                 violation_rate: float = 0.3,
                 min_shelves: int = 3, max_shelves: int = 5,
                 domain_shift: float = 0.0, perspective: float = 0.0):
        _no_perspective(perspective)
        self.n = n
        self.canvas_h = canvas_h
        self.canvas_w = canvas_w
        self.seed = seed
        self.styles = product_styles(n_styles)
        self.violation_rate = violation_rate
        self.min_shelves = min_shelves
        self.max_shelves = max_shelves
        self.domain_shift = domain_shift
        self.perspective = perspective
        self._items: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict:
        if not 0 <= i < self.n:
            raise IndexError(i)
        return _cached_item(self._items, i, lambda: self._render(i))

    def _render(self, i: int) -> Dict:
        rng = np.random.default_rng((self.seed, 77, i))
        vr = 0.0 if i % 2 == 0 else self.violation_rate
        img, _, actual, _ = planogram_scene(
            self.canvas_h, self.canvas_w, self.styles, rng,
            violation_rate=vr, min_shelves=self.min_shelves,
            max_shelves=self.max_shelves)
        boxes = actual["boxes"]
        img, boxes = _augment_scene(img, boxes, rng, self.domain_shift,
                                    self.perspective)
        if not len(boxes):
            boxes = np.asarray([[0, 0, 8, 8]], np.float32)
        return _detection_item(img, boxes, self.canvas_h, self.canvas_w,
                               f"plano_synthetic_{i}")


def _jitter_view(img: np.ndarray, rng: np.random.Generator,
                 strength: float = 0.1) -> np.ndarray:
    """Photometric view jitter: global gain + noise."""
    out = img * rng.uniform(1 - strength, 1 + strength)
    out = out + rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


class ArchetypeGallerySet:
    """(emb_img, gen_img, hierarchy, annotation) tuples in tanh scale
    over the product_styles archetypes (numpy, host). Hierarchy groups
    archetypes into hue families."""

    def __init__(self, styles, views: int = 8, seed: int = 0,
                 families: int = 4, size: int = 256):
        self.styles = styles
        self.views = views
        self.seed = seed
        self.size = size
        k = len(styles)
        self.hierarchies = [
            [f"Family{i * families // max(1, k)}", s["label"]]
            for i, s in enumerate(styles)]
        self._canon = [
            T.resize_for_classification(product_gallery_image(s),
                                        size=size).numpy()
            for s in styles]

    def __len__(self) -> int:
        return len(self.styles) * self.views

    def __getitem__(self, i: int):
        pid, view = divmod(i, self.views)
        rng = np.random.default_rng((self.seed, pid, view))
        base = self._canon[pid]
        emb = base if view == 0 else _jitter_view(base, rng)
        gen = _jitter_view(base, rng)
        return (emb * 2.0 - 1.0, gen * 2.0 - 1.0,
                self.hierarchies[pid], self.styles[pid]["label"])


class PlanogramQuerySet:
    """(scene_img, gt_labels, gt_boxes) eval items over held-out
    planogram scenes (eval_dihe protocol: gt-crop classification)."""

    def __init__(self, styles, n: int = 8, canvas_h: int = 832,
                 canvas_w: int = 1344, seed: int = 10_000,
                 domain_shift: float = 0.0, perspective: float = 0.0):
        _no_perspective(perspective)
        self.styles = styles
        self.n = n
        self.canvas_h = canvas_h
        self.canvas_w = canvas_w
        self.seed = seed
        self.domain_shift = domain_shift
        self.perspective = perspective

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng((self.seed, 5, i))
        img, _, actual, _ = planogram_scene(
            self.canvas_h, self.canvas_w, self.styles, rng,
            domain_shift=self.domain_shift)
        return img, actual["labels"], actual["boxes"]


def apply_domain_shift(img: np.ndarray, rng: np.random.Generator,
                       strength: float) -> np.ndarray:
    """Photometric deployment-domain shift for a rendered scene: color
    cast, gamma, illumination gradient, defocus blur, sensor noise.
    Geometry is untouched. `strength` in [0, 1]; 0 is a no-op."""
    if strength <= 0:
        return img
    out = img.astype(np.float32)
    gains = rng.uniform(1 - 0.3 * strength, 1 + 0.3 * strength, 3)
    out = out * gains.astype(np.float32)
    gamma = float(rng.uniform(1 - 0.35 * strength, 1 + 0.35 * strength))
    out = np.clip(out, 1e-4, None) ** gamma
    gy = np.linspace(*rng.uniform(1 - 0.25 * strength,
                                  1 + 0.25 * strength, 2),
                     out.shape[0], dtype=np.float32)
    gx = np.linspace(*rng.uniform(1 - 0.25 * strength,
                                  1 + 0.25 * strength, 2),
                     out.shape[1], dtype=np.float32)
    out = out * gy[:, None, None] * gx[None, :, None]
    sigma = float(rng.uniform(0.3, 1.6) * strength * 2.0)
    if sigma > 0.2:
        out = T.gaussian_blur(out, sigma)
    out = out + rng.normal(0, 0.04 * strength, out.shape).astype(
        np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)
