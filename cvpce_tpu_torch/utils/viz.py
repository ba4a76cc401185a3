"""Visualization utilities; counterpart of cvpce_tpu/utils/viz.py
(reference: cvpce/utils.py:25-261).

All savers draw with matplotlib's Agg backend, imported inside each
call, so importing this module needs no matplotlib: the card's machine
has none, and a call there raises ModuleNotFoundError (the training
loops check `available()` first and skip their sample pictures). Images
and embeddings may be numpy arrays or tensors on any device; `pca` is
one `torch.linalg.svd` (the JAX package's is one jnp SVD).
"""
from __future__ import annotations

import importlib.util
from typing import Optional, Sequence

import numpy as np
import torch


def available() -> bool:
    """Whether matplotlib is installed (the savers need it)."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pca(embeddings, keepdims: int = 2) -> np.ndarray:
    """Project embeddings to their top principal components
    (cvpce/utils.py:286-288 semantics: u[:, i] * s[i])."""
    x = embeddings if torch.is_tensor(embeddings) else torch.as_tensor(
        np.asarray(embeddings))
    u, s, _ = torch.linalg.svd(x, full_matrices=False)
    return _np(torch.stack([u[:, i] * s[i] for i in range(keepdims)],
                           dim=1))


def save_boxes(img, boxes, out: str, labels=None,
               color: str = "lime") -> None:
    """Detection/annotation overlay (cvpce/utils.py:25-63)."""
    plt = _plt()
    from matplotlib import patches

    fig, ax = plt.subplots(figsize=(12, 9))
    ax.imshow(np.clip(_np(img), 0, 1))
    for i, (x1, y1, x2, y2) in enumerate(_np(boxes)):
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       fill=False, edgecolor=color))
        if labels is not None:
            ax.text(x1, y1, str(labels[i]), color="yellow", fontsize=6)
    ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)


def save_heatmap(heatmap, out: str) -> None:
    """Gaussian heatmap render (used by GLN checkpoints,
    proposals_training.py:100)."""
    plt = _plt()
    hm = _np(heatmap).squeeze()
    plt.imsave(out, hm, cmap="hot")


def save_multiple(images: Sequence, out: str) -> None:
    """Side-by-side image strip (cvpce/utils.py save_multiple analogue,
    used for GAN source/fake/target triplets)."""
    plt = _plt()
    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    axes = np.atleast_1d(axes)
    for ax, img in zip(axes, images):
        ax.imshow(np.clip(_np(img).squeeze(), 0, 1))
        ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)


def save_dataset_sample(test_imgs: Sequence, test_boxes: Sequence,
                        test_labels: Sequence, train_imgs: Sequence,
                        train_labels: Sequence, out: str) -> None:
    """Dataset overview: test scenes (with GT boxes) on top, a grid of
    training-product thumbnails below (cvpce/utils.py draw_dataset_sample,
    used by `datasets grozi visualize` / `datasets internal visualize`)."""
    plt = _plt()
    from matplotlib import patches

    n_test = max(len(test_imgs), 1)
    n_train = len(train_imgs)
    cols = max(n_test, min(n_train, 4), 1)
    train_rows = int(np.ceil(n_train / cols)) if n_train else 0
    fig, axes = plt.subplots(1 + train_rows, cols,
                             figsize=(4 * cols, 4 * (1 + train_rows)),
                             squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")
    for i, img in enumerate(test_imgs):
        ax = axes[0][i]
        ax.imshow(np.clip(_np(img).squeeze(), 0, 1))
        for j, (x1, y1, x2, y2) in enumerate(
                _np(test_boxes[i]).reshape(-1, 4)):
            ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                           fill=False, edgecolor="lime"))
            if i < len(test_labels) and j < len(test_labels[i]):
                ax.text(x1, y1, str(test_labels[i][j]), color="yellow",
                        fontsize=6)
    for i, img in enumerate(train_imgs):
        ax = axes[1 + i // cols][i % cols]
        ax.imshow(np.clip(_np(img).squeeze(), 0, 1))
        if i < len(train_labels):
            ax.set_title(str(train_labels[i]), fontsize=8)
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)


def save_embedding_scatter(embeddings, out: str,
                           labels: Optional[Sequence] = None,
                           fake_embeddings=None) -> None:
    """PCA scatter of embeddings, optionally real-vs-generated
    (cvpce/utils.py:65-136 analogue)."""
    plt = _plt()
    embeddings = _np(embeddings)
    proj = pca(embeddings)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(proj[:, 0], proj[:, 1], s=12, label="real")
    if fake_embeddings is not None:
        both = np.concatenate([embeddings, _np(fake_embeddings)])
        proj_all = pca(both)
        n = len(embeddings)
        ax.clear()
        ax.scatter(proj_all[:n, 0], proj_all[:n, 1], s=12, label="real")
        ax.scatter(proj_all[n:, 0], proj_all[n:, 1], s=12, marker="x",
                   label="generated")
    if labels is not None:
        for i, lbl in enumerate(labels):
            ax.annotate(str(lbl), proj[i], fontsize=5)
    ax.legend()
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_prfc(precision, recall, fscore, confidence, out: str,
              title: Optional[str] = None,
              resolution_reduction: int = 1) -> None:
    """Recall-vs-{precision, F1, confidence} curves with max-F1
    annotations (cvpce/metrics.py:177-204)."""
    plt = _plt()
    precision = _np(precision)
    recall = _np(recall)
    fscore = _np(fscore)
    confidence = _np(confidence)

    fig = plt.figure(figsize=(5, 2.5))
    mi = int(fscore.argmax()) if len(fscore) else 0
    if len(fscore):
        plt.vlines(recall[mi], 0, 1, color="red", label="Max. $F_1$")
        for val, color in ((confidence[mi], "orange"),
                           (precision[mi], "blue"), (fscore[mi], "green")):
            plt.hlines(val, 0, recall[mi], color=color, linestyles="dashed")
    rr = slice(None, None, resolution_reduction)
    plt.plot(recall[rr], confidence[rr], label="Confidence", color="orange")
    plt.plot(recall[rr], precision[rr], label="Precision", color="blue")
    plt.plot(recall[rr], fscore[rr], label="$F_1$", color="green")
    if title:
        plt.title(title)
    plt.xlabel("Recall")
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.legend()
    fig.tight_layout(pad=0.5)
    fig.savefig(out, dpi=120)
    plt.close(fig)


def category_treemap(counts: dict, out: str) -> None:
    """Category distribution treemap (cvpce/utils.py:230-261 uses
    squarify; this is a matplotlib-only slice-and-dice layout)."""
    plt = _plt()
    from matplotlib import patches

    total = sum(counts.values()) or 1
    fig, ax = plt.subplots(figsize=(8, 6))
    x = 0.0
    items = sorted(counts.items(), key=lambda kv: -kv[1])
    colors = plt.cm.tab20(np.linspace(0, 1, max(len(items), 1)))
    for (name, n), color in zip(items, colors):
        w = n / total
        ax.add_patch(patches.Rectangle((x, 0), w, 1, facecolor=color,
                                       edgecolor="white"))
        if w > 0.03:
            ax.text(x + w / 2, 0.5, f"{name}\n{n}", ha="center",
                    va="center", fontsize=7, rotation=90 if w < 0.08 else 0)
        x += w
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.axis("off")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)


def draw_planogram(boxes, labels: Sequence, out: str,
                   matched=None) -> None:
    """Abstract planogram layout drawing (cvpce/utils.py:159-203)."""
    plt = _plt()
    from matplotlib import patches

    boxes = _np(boxes)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.set_xlim(boxes[:, 0].min() - 1, boxes[:, 2].max() + 1)
    ax.set_ylim(boxes[:, 1].min() - 1, boxes[:, 3].max() + 1)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        color = "green" if matched is None or matched[i] else "red"
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       fill=False, edgecolor=color))
        ax.text((x1 + x2) / 2, (y1 + y2) / 2, str(labels[i]), fontsize=5,
                ha="center", va="center")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
