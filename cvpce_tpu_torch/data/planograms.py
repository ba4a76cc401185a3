"""Planogram adapters and planogram test sets; counterpart of
cvpce_tpu/data/planograms.py.

`read_tonioni_planogram` reads a GP-180 planogram JSON, a grid graph
(nodes with n/s/e/w neighbour indices and `ogg` product refs): N/S edges
are flipped into detector coordinates, west-edge rows and south-edge
columns are walked, and row-y / column-x coordinates are solved from the
product widths and heights, giving boxes, labels and a graph. The graph
is the port's `pipeline.planograms.Graph`, with the nodes, edges,
`label` and `dir` attributes of the JAX package's DiGraph, in the same
insertion order.
"""
from __future__ import annotations

import json
from os import path
from typing import Dict, List

import numpy as np

from ..pipeline.planograms import Graph
from . import transforms as T
from .grocery import GroceryProductsTestSet


# Tonioni JSON neighbor key -> detector-space edge direction. The JSON's
# y axis points up while detections grow downward, so n/s invert.
_KEY_TO_DETECTOR_DIR = {"n": "S", "s": "N", "e": "E", "w": "W"}


def _walk_chain(g: Graph, head: int, direction: str,
                axis_name: str, src: str) -> List[int]:
    """Follow `direction` edges from a grid-edge node. A well-formed
    planogram grid has at most one successor per node per direction."""
    chain = [head]
    while True:
        succ = [v for v in g[chain[-1]]
                if g[chain[-1]][v]["dir"] == direction]
        if not succ:
            return chain
        if len(succ) > 1:
            raise RuntimeError(
                f"planogram grid is not a chain along {axis_name}: "
                f"node {chain[-1]} has {direction}-successors "
                f"{sorted(succ)} ({src})")
        chain.append(succ[0])


def _solve_axis(chains: List[List[int]], membership: Dict[int, int],
                extent: Dict[int, float]) -> Dict[int, float]:
    """Solve 1-D coordinates for the cross-chain ids of one grid axis.

    Each chain lays its nodes out consecutively by their extents; a
    cross id shared by several chains takes the maximum start seen.
    Two sweeps: the first anchors every chain to an already-solved
    cross id where possible (else 0) and collects maxima; the second
    pushes residual overlaps forward in chain order. Used for both
    column-x (row chains, widths) and row-y (column chains, heights);
    semantics match cvpce/planogram_adapters.py:55-103.
    """
    coord: Dict[int, float] = {}
    for chain in chains:
        anchor = 0.0
        run = 0.0
        for node in chain:
            cid = membership[node]
            if cid in coord:
                anchor = coord[cid] - run
                break
            run += extent[node]
        run = anchor
        for node in chain:
            cid = membership[node]
            coord[cid] = max(run, coord.get(cid, float("-inf")))
            run += extent[node]
    for chain in chains:
        frontier = coord[membership[chain[0]]] + extent[chain[0]]
        for node in chain[1:]:
            cid = membership[node]
            coord[cid] = max(coord[cid], frontier)
            frontier = coord[cid] + extent[node]
    return coord


def read_tonioni_planogram(planogram_path: str):
    """Parse a GP-180 planogram grid JSON into concrete geometry.

    Returns (boxes (N, 4) float32 xyxy, labels list[str], Graph with
    `label` node attrs and `dir` edge attrs). Nodes carry n/s/e/w
    neighbour indices (-1 = none) plus an `ogg` product ref; box sizes
    come from the product widths/heights and positions from
    chain-walking the grid's west and south edges.
    """
    with open(planogram_path, "r") as f:
        spec = json.load(f)

    g = Graph()
    for i, entry in enumerate(spec["graph"]):
        g.add_node(i)
        for key, det_dir in _KEY_TO_DETECTOR_DIR.items():
            if entry.get(key, -1) >= 0:
                g.add_edge(i, entry[key], dir=det_dir)

    products = [spec["objects"][entry["ogg"]] for entry in spec["graph"]]
    width = {i: float(p["width"]) for i, p in enumerate(products)}
    height = {i: float(p["height"]) for i, p in enumerate(products)}

    # grid-edge heads: rows start where nothing lies west; columns start
    # where nothing lies south (= JSON north, pre-flip).
    row_chains = [
        _walk_chain(g, i, "E", "a shelf row", planogram_path)
        for i, entry in enumerate(spec["graph"]) if entry["w"] == -1]
    col_chains = [
        _walk_chain(g, i, "N", "a product column", planogram_path)
        for i, entry in enumerate(spec["graph"]) if entry["n"] == -1]
    row_of = {n: chain[0] for chain in row_chains for n in chain}
    col_of = {n: chain[0] for chain in col_chains for n in chain}

    col_x = _solve_axis(row_chains, col_of, width)
    row_y = _solve_axis(col_chains, row_of, height)

    n = len(spec["graph"])
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        x1 = col_x[col_of[i]]
        y2 = row_y[row_of[i]]  # row coordinate = the box's bottom edge
        boxes[i] = [x1, y2 - height[i], x1 + width[i], y2]

    # label = img_path up to its first dot (keeps any directory prefix —
    # GP annotations use category-path labels)
    labels = [p["img_path"].split(".")[0] for p in products]
    for i, label in enumerate(labels):
        g.nodes[i]["label"] = label

    return boxes, labels, g


class PlanogramTestSet(GroceryProductsTestSet):
    """GP-180 test images + parsed Tonioni planograms; GP planograms are
    fully compliant, so actual_accuracy = 1.0. Items (img numpy, anns,
    boxes, plano)."""

    def __init__(self, image_dir, ann_dir, plano_dir, only=None, skip=None):
        self.plano_dir = plano_dir
        super().__init__(image_dir, ann_dir, only, skip)

    def _build_index(self, ann_dir, only, skip):
        index = super()._build_index(ann_dir, only, skip)
        for entry in index:
            s, i = entry["id"]
            boxes, labels, g = read_tonioni_planogram(
                path.join(self.plano_dir, f"s{s}_{i}.json"))
            entry["plano"] = {
                "boxes": boxes, "labels": labels, "graph": g,
                "actual_accuracy": 1.0,
            }
        return index

    def __getitem__(self, i: int):
        img, anns, boxes = super().__getitem__(i)
        return img, anns, boxes, self.index[i]["plano"]


class InternalPlanoSet:
    """index.json + per-image planogram JSON with code/box entries;
    y-flipped to detector coords; ground-truth accuracy = correct /
    facings. Items (img numpy, {labels, boxes, actual_accuracy})."""

    def __init__(self, root: str):
        self.index = self._build_index(root)

    @staticmethod
    def _build_index(root: str) -> List[Dict]:
        with open(path.join(root, "index.json"), "r") as f:
            index = json.load(f)
        res = []
        for obj in index:
            with open(path.join(root, obj["planogram"]), "r") as f:
                plano = json.load(f)
            anns = [e["code"] for e in plano]
            boxes = np.asarray([e["box"] for e in plano], np.float32)
            maxy = boxes[:, 3].max()
            tmp = maxy - boxes[:, 3]
            boxes[:, 3] = maxy - boxes[:, 1]
            boxes[:, 1] = tmp
            res.append({
                "img": path.join(root, obj["image"]),
                "anns": anns,
                "boxes": boxes,
                "actual_accuracy": obj["correct"] / obj["facings"],
            })
        return res

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int):
        e = self.index[i]
        img = T.load_image(e["img"])
        return img, {"labels": e["anns"], "boxes": e["boxes"],
                     "actual_accuracy": e["actual_accuracy"]}
