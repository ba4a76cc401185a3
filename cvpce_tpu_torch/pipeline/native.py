"""ctypes bindings for the native planogram graph engine; counterpart of
cvpce_tpu/pipeline/native.py.

`csrc/graph_match.cpp` is a byte-identical copy of the JAX package's
`native/graph_match.cpp`. `_build.py` compiles it with the host compiler
(`g++ -O3 -shared -fPIC -std=c++17`) into `build/cvpce_tpu_torch/` at
first use. `build_graph` and `large_common_subgraph` keep the contracts
of the pure-Python versions in pipeline/planograms.py and return the
port's `Graph`. There is no fallback: where the library does not build,
the first call raises. `CALLS` counts the calls into the library.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Set, Tuple

import numpy as np

from .. import _build
from .planograms import CARDINALS, Graph

CALLS = {"build_graph": 0, "large_common_subgraph": 0}

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def load() -> ctypes.CDLL:
    """The typed library (`_build` builds it on first use and keeps it
    loaded); raises where it does not build."""
    lib = _build.load("graph_match")
    lib.build_graph.restype = ctypes.c_int32
    lib.build_graph.argtypes = [_F32P, ctypes.c_int32, ctypes.c_float,
                                _I32P, _F32P, ctypes.c_int32]
    lib.large_common_subgraph.restype = ctypes.c_int32
    lib.large_common_subgraph.argtypes = [
        ctypes.c_int32, _I32P, _I32P, ctypes.c_int32,
        ctypes.c_int32, _I32P, _I32P, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, _I32P, ctypes.c_int32]
    return lib


def _ptr_f32(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _ptr_i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def build_graph(boxes, labels: Sequence, thresh_size: float = 0.5
                ) -> Graph:
    """Native pipeline.planograms.build_graph."""
    lib = load()
    boxes = np.ascontiguousarray(np.asarray(boxes, np.float32))
    n = len(boxes)
    cap = max(16 * n, 64)
    edges = np.empty((cap, 3), np.int32)
    weights = np.empty(cap, np.float32)
    cnt = lib.build_graph(_ptr_f32(boxes), n, ctypes.c_float(thresh_size),
                          _ptr_i32(edges), _ptr_f32(weights), cap)
    CALLS["build_graph"] += 1
    if cnt < 0:
        raise RuntimeError("graph_match: edge capacity exceeded")
    g = Graph()
    for i in range(n):
        g.add_node(i, label=labels[i])
    for k in range(cnt):
        i, j, d = edges[k]
        g.add_edge(int(i), int(j), dir=CARDINALS[int(d)],
                   weight=float(weights[k]))
    return g


def _graph_arrays(g: Graph, label_ids: Dict) -> Tuple[np.ndarray, ...]:
    nodes = sorted(g.nodes)
    index = {node: i for i, node in enumerate(nodes)}
    labels = np.asarray(
        [label_ids.setdefault(g.nodes[node]["label"], len(label_ids))
         for node in nodes], np.int32)
    rows = [(index[u], index[v], CARDINALS.index(g[u][v]["dir"]))
            for u in nodes for v in g[u]]
    edges = (np.asarray(rows, np.int32) if rows
             else np.zeros((0, 3), np.int32))
    return labels, edges, np.asarray(nodes)


def large_common_subgraph(g1: Graph, g2: Graph, min_score: float = -0.2,
                          stop_at_fraction: float = 0.5) -> Set[Tuple]:
    """Native pipeline.planograms.large_common_subgraph."""
    lib = load()
    label_ids: Dict = {}
    l1, e1, nodes1 = _graph_arrays(g1, label_ids)
    l2, e2, nodes2 = _graph_arrays(g2, label_ids)
    cap = max(min(len(l1), len(l2)), 1)
    out = np.empty((cap, 2), np.int32)
    cnt = lib.large_common_subgraph(
        len(l1), _ptr_i32(l1), _ptr_i32(np.ascontiguousarray(e1)), len(e1),
        len(l2), _ptr_i32(l2), _ptr_i32(np.ascontiguousarray(e2)), len(e2),
        ctypes.c_float(min_score), ctypes.c_float(stop_at_fraction),
        _ptr_i32(out), cap)
    CALLS["large_common_subgraph"] += 1
    if cnt < 0:
        raise RuntimeError("graph_match: pair capacity exceeded")
    return {(int(nodes1[a]), int(nodes2[b])) for a, b in out[:cnt]}
