"""The port's native graph engine (pipeline/native.py over
csrc/graph_match.cpp, built with g++ at first use) against the port's
pure-Python build_graph / large_common_subgraph, on the grids and random
layouts of tests/test_native_graph.py, and against the JAX package's
native bindings; the comparator's native default and its explicit
pure-Python route."""
import filecmp
import os

import numpy as np
import pytest

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.pipeline import native as j_native
from cvpce_tpu_torch import _build
from cvpce_tpu_torch.pipeline import native
from cvpce_tpu_torch.pipeline import planograms as pg
from cvpce_tpu_torch.pipeline.evaluator import PlanogramComparator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grid_boxes(rows, cols, w=10.0, h=10.0, gap=2.0):
    return np.asarray([[c * (w + gap), r * (h + gap),
                        c * (w + gap) + w, r * (h + gap) + h]
                       for r in range(rows) for c in range(cols)],
                      np.float32)


def random_layout(trial):
    rng = np.random.default_rng(0)
    for _ in range(trial + 1):
        xy = rng.uniform(0, 120, (24, 2)).astype(np.float32)
        wh = rng.uniform(8, 20, (24, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1), [f"p{i % 7}"
                                                for i in range(24)]


def edges(g):
    """Every edge in adjacency order, with its attributes."""
    return [(u, v, dict(g[u][v])) for u in g for v in g[u]]


def graphs_equal(g1, g2):
    e1 = {(u, v, a["dir"]) for u, v, a in edges(g1)}
    e2 = {(u, v, a["dir"]) for u, v, a in edges(g2)}
    return g1.nodes == g2.nodes and e1 == e2


def test_source_is_a_byte_copy_of_the_jax_packages():
    assert filecmp.cmp(
        os.path.join(REPO, "cvpce_tpu_torch", "csrc", "graph_match.cpp"),
        os.path.join(REPO, "native", "graph_match.cpp"), shallow=False)


@pytest.mark.parametrize("rows,cols", [(2, 3), (3, 3), (1, 5), (4, 6)])
def test_build_graph_matches_python_on_grids(rows, cols):
    boxes = grid_boxes(rows, cols)
    labels = [f"p{i}" for i in range(rows * cols)]
    assert graphs_equal(native.build_graph(boxes, labels),
                        pg.build_graph(boxes, labels))


@pytest.mark.parametrize("trial", range(5))
def test_build_graph_matches_python_on_random_layouts(trial):
    boxes, labels = random_layout(trial)
    got = native.build_graph(boxes, labels)
    assert graphs_equal(got, pg.build_graph(boxes, labels))
    # and the JAX package's binding edge for edge, in the same order
    want = j_native.build_graph(boxes, labels)
    assert edges(got) == [(u, v, dict(want[u][v])) for u in want
                          for v in want[u]]


def test_lcs_matches_python_on_grids():
    boxes = grid_boxes(3, 4)
    labels = [f"p{i}" for i in range(12)]
    g1 = pg.build_graph(boxes, labels)
    g2 = pg.build_graph(boxes * 1.07 + 3.0, labels)
    assert native.large_common_subgraph(g1, g2) == \
        pg.large_common_subgraph(g1, g2)


def test_lcs_with_noise_and_missing():
    rng = np.random.default_rng(1)
    boxes = grid_boxes(4, 5)
    labels = [f"p{i}" for i in range(20)]
    keep = [i for i in range(20) if i != 7 and i != 13]
    noisy = boxes[keep] + rng.uniform(-1, 1, (len(keep), 4)).astype(
        np.float32)
    g1 = pg.build_graph(boxes, labels)
    g2 = pg.build_graph(noisy, [labels[i] for i in keep])
    assert native.large_common_subgraph(g1, g2) == \
        pg.large_common_subgraph(g1, g2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_jax_native_on_scenes(seed):
    """Planogram against rendered scene with violations: the port's and
    the JAX package's native engines give the same matching."""
    styles = j_syn.product_styles(8)
    _, plano, actual, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng((seed, 9)),
        violation_rate=0.3)
    pb, pl = plano["boxes"], plano["labels"]
    ab, al = actual["boxes"], actual["labels"]
    got = native.large_common_subgraph(native.build_graph(pb, pl),
                                       native.build_graph(ab, al))
    want = j_native.large_common_subgraph(j_native.build_graph(pb, pl),
                                          j_native.build_graph(ab, al))
    assert got == want and len(got) > 0
    assert got == pg.large_common_subgraph(pg.build_graph(pb, pl),
                                           pg.build_graph(ab, al))


@pytest.mark.parametrize("seed", [3, 4])
def test_comparator_native_and_python_routes_agree(seed):
    styles = j_syn.product_styles(8)
    _, plano, actual, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng((seed, 9)),
        violation_rate=0.3)
    expected = {"boxes": plano["boxes"], "labels": plano["labels"]}
    before = dict(native.CALLS)
    got = PlanogramComparator(device="cpu").compare_detailed(expected,
                                                             actual)
    assert native.CALLS["build_graph"] == before["build_graph"] + 2
    assert native.CALLS["large_common_subgraph"] == \
        before["large_common_subgraph"] + 1
    python = PlanogramComparator(use_native=False, device="cpu")
    assert python._native is None
    want = python.compare_detailed(expected, actual)
    assert got[0] == want[0] and got[2] == want[2] == "ransac"
    np.testing.assert_array_equal(got[1], want[1])


def test_no_quiet_fallback_without_a_compiler(monkeypatch, tmp_path):
    """Where the library cannot build, use_native=True raises; the
    pure-Python route is only ever taken when asked for."""
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CVPCE_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        PlanogramComparator(device="cpu")
    assert PlanogramComparator(use_native=False, device="cpu")._native \
        is None
