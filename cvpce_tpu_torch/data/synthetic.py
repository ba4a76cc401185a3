"""Deterministic synthetic planogram scenes and product gallery renders.

numpy-only copy of the parts of cvpce_tpu/data/synthetic.py that the
serving path needs: `product_styles`, `product_gallery_image` and
`planogram_scene` (without the photometric domain shift, which needs
OpenCV). The same (seed, arguments) give the same arrays as the JAX
package's functions.
"""
from __future__ import annotations

import numpy as np


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
                    fill: float = 0.92):
    """Render a planogram-driven shelf scene.

    Returns (img, planogram, actual, expected_compliance) where
    planogram = {"boxes", "labels", "violations"} is the INTENDED
    layout ("violations": per-slot "intact"/"removed"/"swapped", for
    error attribution), actual = {"boxes", "labels"} the rendered
    ground truth (violations applied: 'removed' products absent,
    'swapped' rendered as another archetype), and expected_compliance
    = intact / planned.
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
