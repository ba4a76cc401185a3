"""Planogram graphs, greedy common-subgraph matching and RANSAC
finalization; counterpart of cvpce_tpu/pipeline/planograms.py.

Graphs are `Graph` objects made of two plain dicts, `nodes` (node ->
attribute dict) and `adj` (node -> {neighbour -> edge attribute dict}),
kept in insertion order the way networkx keeps its adjacency, so the
pure-Python matching visits nodes and edges in the JAX package's order.
The homography fit runs in torch (ops/ransac.py).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from ..ops.boxes import pairwise_iou
from ..ops.ransac import find_homography_ransac, project_boxes
from ..utils import labels_to_tensors, resolve_device, tensors_to_labels

CARDINALS = ["E", "NE", "N", "NW", "W", "SW", "S", "SE"]


class Graph:
    """Directed graph on plain dicts: `g[n]` is n's out-edge dict."""

    def __init__(self):
        self.nodes: Dict = {}
        self.adj: Dict = {}

    def add_node(self, n, **attrs) -> None:
        self.nodes.setdefault(n, {}).update(attrs)
        self.adj.setdefault(n, {})

    def add_edge(self, u, v, **attrs) -> None:
        self.add_node(u)
        self.add_node(v)
        self.adj[u].setdefault(v, {}).update(attrs)

    def remove_edge(self, u, v) -> None:
        del self.adj[u][v]

    def __getitem__(self, n) -> Dict:
        return self.adj[n]

    def __iter__(self):
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)


def _direction_masks(boxes: np.ndarray):
    centres = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                        (boxes[:, 1] + boxes[:, 3]) / 2], axis=1)
    diff = centres[None, :, :] - centres[:, None, :]
    dists = np.sqrt((diff ** 2).sum(-1))
    with np.errstate(invalid="ignore", divide="ignore"):
        dir_vecs = diff / dists[..., None]
    dirs = np.arccos(np.clip(dir_vecs[..., 0], -1, 1))
    over_180 = dir_vecs[..., 1] < 0
    dirs[over_180] = 2 * math.pi - dirs[over_180]
    masks = {"E": (dirs > 15 * math.pi / 8) | (dirs <= math.pi / 8)}
    for i, d in enumerate(CARDINALS[1:]):
        masks[d] = (dirs > (1 + 2 * i) * math.pi / 8) \
            & (dirs <= (1 + 2 * (i + 1)) * math.pi / 8)
    return dists, masks


def _check_dir(i: int, j: int, direction: str, masks, graph: Graph,
               dist: float) -> bool:
    """Try an i->j edge in `direction`, keeping only the shortest
    opposing edge per node."""
    if not masks[direction][i, j]:
        return False
    opposite = CARDINALS[(CARDINALS.index(direction) + 4) % 8]
    for k in graph[j]:
        edge = graph[j][k]
        if edge["dir"] == opposite:
            if edge["weight"] <= dist:
                return False
            graph.remove_edge(j, k)
            graph.remove_edge(k, j)
            break
    graph.add_edge(i, j, dir=direction, weight=dist)
    graph.add_edge(j, i, dir=opposite, weight=dist)
    return True


def build_graph(boxes, labels: Sequence, thresh_size: float = 0.5) -> Graph:
    """Per node, connect the nearest neighbour in each of 8 sectors
    within thresh_size * mean(extent)."""
    boxes = np.asarray(boxes, np.float32)
    n = len(boxes)
    avg_dim = ((boxes[:, 2].max() - boxes[:, 0].min())
               + (boxes[:, 3].max() - boxes[:, 1].min())) / 2
    thresh = thresh_size * avg_dim
    dists, masks = _direction_masks(boxes)
    g = Graph()
    for i in range(n):
        g.add_node(i, label=labels[i])
    sort_idx = np.argsort(dists, axis=1, kind="stable")
    sorted_dist = np.take_along_axis(dists, sort_idx, axis=1)
    for i in range(n):
        not_found = set(CARDINALS)
        for neigh in g[i]:
            not_found.discard(g[i][neigh]["dir"])
        for d, j in zip(sorted_dist[i], sort_idx[i]):
            if d > thresh or not not_found:
                break
            j = int(j)
            if i == j:
                continue
            for direction in list(not_found):
                if _check_dir(i, j, direction, masks, g, float(d)):
                    not_found.remove(direction)
                    break
    return g


def _outgoing_by_dir(g: Graph, n, edge_label: str) -> Dict:
    return {g[n][v][edge_label]: g.nodes[v] for v in g[n]}


def build_hypotheses(g1: Graph, g2: Graph,
                     edge_label: str = "dir") -> List[Tuple]:
    """Like-labelled node pairs scored by direction agreement, best
    first (ascending negated score)."""
    table1 = {n: _outgoing_by_dir(g1, n, edge_label) for n in g1}
    table2 = {n: _outgoing_by_dir(g2, n, edge_label) for n in g2}
    out = []
    for n1 in g1:
        for n2 in g2:
            if g1.nodes[n1] != g2.nodes[n2]:
                continue
            d1, d2 = table1[n1], table2[n2]
            agree = sum(1 for c, attrs in d1.items()
                        if c in d2 and d2[c] == attrs)
            out.append((-agree / len(CARDINALS), n1, n2))
    out.sort()
    return out


def _aligned_neighbors(g1, g2, n1, n2, edge_label: str) -> List[Tuple]:
    bucket: Dict = {}
    for e2 in g2[n2]:
        bucket.setdefault(g2[n2][e2][edge_label], []).append(e2)
    pairs = []
    for e1 in g1[n1]:
        for e2 in bucket.get(g1[n1][e1][edge_label], ()):
            if g1.nodes[e1] == g2.nodes[e2]:
                pairs.append((e1, e2))
    return pairs


def _grow_region(g1, g2, n1, n2, edge_label: str) -> Set[Tuple]:
    region = {(n1, n2)}
    taken1, taken2 = {n1}, {n2}
    frontier = deque(_aligned_neighbors(g1, g2, n1, n2, edge_label))
    while frontier:
        a, b = frontier.popleft()
        if a in taken1 or b in taken2:
            continue
        region.add((a, b))
        taken1.add(a)
        taken2.add(b)
        frontier.extend(_aligned_neighbors(g1, g2, a, b, edge_label))
    return region


def large_common_subgraph(g1: Graph, g2: Graph, edge_label: str = "dir",
                          min_score: float = -0.2,
                          stop_at_fraction: float = 0.5) -> Set[Tuple]:
    """Grow a region from each hypothesis in score order; stop once one
    covers `stop_at_fraction` of the smaller graph."""
    enough = min(len(g1), len(g2)) * stop_at_fraction
    best: Set[Tuple] = set()
    for neg_score, n1, n2 in build_hypotheses(g1, g2, edge_label):
        if neg_score > min_score and best:
            break
        region = _grow_region(g1, g2, n1, n2, edge_label)
        if len(region) > enough:
            return region
        if len(region) > len(best):
            best = region
    return best


def tonioni_mcs(g1: Graph, g2: Graph, edge_label: str = "dir",
                min_score: float = -0.2) -> Set[Tuple]:
    """Branch-and-bound maximum-common-subgraph variant (the reference's
    unused alternative to large_common_subgraph): from each hypothesis
    in score order, repeatedly commit the strongest one, rescore and
    prune the rest, and keep the largest set of pairs found."""

    def descend(hypo: List[Tuple], incumbent: int) -> Set[Tuple]:
        """Commit hypotheses until scores drop below `min_score` or the
        optimistic bound (committed + pairwise-disjoint survivors) can
        no longer beat the incumbent."""
        chosen: Set[Tuple] = set()
        while hypo:
            neg_s, n1, n2 = hypo[0]
            if neg_s > min_score:
                break
            chosen.add((n1, n2))
            adjacent = set(_aligned_neighbors(g1, g2, n1, n2, edge_label))
            seen1: Set = set()
            seen2: Set = set()
            bound = 0
            survivors = []
            for neg_s2, x1, x2 in hypo[1:]:
                if x1 == n1 or x2 == n2:
                    continue  # mutually exclusive with the commit
                if (x1, x2) in adjacent:
                    neg_s2 -= 1  # reward connectivity to the region
                if x1 not in seen1 and x2 not in seen2:
                    bound += 1
                seen1.add(x1)
                seen2.add(x2)
                survivors.append((neg_s2, x1, x2))
            if len(chosen) + bound < incumbent:
                break
            hypo = sorted(survivors)
        return chosen

    hypotheses = build_hypotheses(g1, g2, edge_label)
    best: Set[Tuple] = set()
    for i in range(len(hypotheses)):
        if len(best) > len(hypotheses) - i:
            break
        sol = descend(hypotheses[i:], len(best))
        if len(sol) > len(best):
            best = sol
    return best


def _ransac_points(boxes: np.ndarray) -> np.ndarray:
    """Top-left, bottom-right and centre point per box."""
    centres = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                        (boxes[:, 1] + boxes[:, 3]) / 2], axis=1)
    return np.concatenate([boxes[:, :2], boxes[:, 2:], centres], axis=0)


def _ransac_points_cross(boxes: np.ndarray) -> np.ndarray:
    """Cross variant: centre and the four edge midpoints (top, bottom,
    left, right) per box, the reference's unused alternative;
    finalize_via_ransac takes it as `points_fn`."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    centres = np.stack([cx, cy], axis=1)
    tops = np.stack([cx, boxes[:, 1]], axis=1)
    bottoms = np.stack([cx, boxes[:, 3]], axis=1)
    lefts = np.stack([boxes[:, 0], cy], axis=1)
    rights = np.stack([boxes[:, 2], cy], axis=1)
    return np.concatenate([centres, tops, bottoms, lefts, rights], axis=0)


def finalize_via_ransac(solution: Set[Tuple], b1, b2, l1: Sequence,
                        l2: Sequence, reproj_threshold: float = 10.0,
                        iou_threshold: float = 0.5,
                        return_matched_actual: bool = False,
                        return_expected_positions: bool = False,
                        seed: int = 0, points_fn=None, device="cuda"):
    """Fit the expected->actual homography on matched pairs (points per
    box from `points_fn`, default `_ransac_points`), project all
    expected boxes, match per label by IoU. Returns (matched_expected,
    [matched_actual,] [expected_positions,] missing_indices,
    missing_positions, missing_labels), the bracketed entries when their
    flag is set, or as many Nones when no homography fits."""
    b1 = np.asarray(b1, np.float32)
    b2 = np.asarray(b2, np.float32)
    nodes1, nodes2 = (list(x) for x in zip(*solution))
    boxes1 = b1[nodes1]
    boxes2 = b2[nodes2]
    points_fn = points_fn or _ransac_points
    pts1 = points_fn(boxes1)
    pts2 = points_fn(boxes2)
    if len(solution) < 2:
        pts1 = np.concatenate([pts1, boxes1[:, (2, 1)], boxes1[:, (0, 3)]])
        pts2 = np.concatenate([pts2, boxes2[:, (2, 1)], boxes2[:, (0, 3)]])

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, _, ok = find_homography_ransac(
        torch.from_numpy(pts1).to(dev), torch.from_numpy(pts2).to(dev),
        torch.ones(len(pts1), dtype=torch.bool, device=dev), gen,
        reproj_threshold=reproj_threshold)
    if not bool(ok):
        return (None,) * (4 + return_matched_actual
                          + return_expected_positions)
    expected_t = project_boxes(h, torch.from_numpy(b1).to(dev))
    expected_positions = expected_t.cpu().numpy()
    b2_t = torch.from_numpy(b2).to(dev)

    l1_ids, l2_ids, key = labels_to_tensors(l1, l2)
    matched_expected = np.zeros(len(expected_positions), bool)
    matched_actual = np.zeros(len(b2), bool)
    for lbl in range(len(key)):
        rev_exp = np.where(l1_ids == lbl)[0]
        rev_act = np.where(l2_ids == lbl)[0]
        if not len(rev_exp) or not len(rev_act):
            continue
        ious = pairwise_iou(expected_t[torch.from_numpy(rev_exp).to(dev)],
                            b2_t[torch.from_numpy(rev_act).to(dev)]
                            ).cpu().numpy()
        used = np.zeros(len(rev_act), bool)
        order = np.argsort(-ious, axis=1, kind="stable")
        # like the reference, an expected box consumes every not-yet-used
        # actual above the IoU threshold
        for i in range(len(rev_exp)):
            for j in order[i]:
                if ious[i, j] < iou_threshold:
                    break
                if used[j]:
                    continue
                used[j] = True
                matched_expected[rev_exp[i]] = True
                matched_actual[rev_act[j]] = True

    missing = np.where(~matched_expected)[0]
    missing_labels = tensors_to_labels(key, l1_ids[missing])[0]
    out = [matched_expected]
    if return_matched_actual:
        out.append(matched_actual)
    if return_expected_positions:
        out.append(expected_positions)
    return (*out, missing, expected_positions[missing], missing_labels)
