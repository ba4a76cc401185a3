"""The reference's alternative planogram matchers, in the port against
the JAX package: `tonioni_mcs` (branch and bound) on seeded planogram
graphs, and `finalize_via_ransac` with the cross points
(`_ransac_points_cross`) and each of its return flags. RANSAC draws from
a torch generator in the port and from jax.random in the JAX package, so
the RANSAC inputs are exact: the actual boxes are the expected ones under
one affine map, and every four-point sample gives the same homography."""
import numpy as np
import pytest

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.pipeline import planograms as j_pg
from cvpce_tpu_torch import pipeline
from cvpce_tpu_torch.pipeline import planograms as pg


def planogram(seed, violation_rate=0.3):
    styles = j_syn.product_styles(8)
    _, plano, actual, _ = j_syn.planogram_scene(
        416, 672, styles, np.random.default_rng((seed, 9)),
        violation_rate=violation_rate)
    return plano["boxes"], plano["labels"], actual["boxes"], actual["labels"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tonioni_mcs_matches_jax(seed):
    b1, l1, b2, l2 = planogram(seed)
    got = pg.tonioni_mcs(pg.build_graph(b1, l1), pg.build_graph(b2, l2))
    want = j_pg.tonioni_mcs(j_pg.build_graph(b1, l1),
                            j_pg.build_graph(b2, l2))
    assert got == want and len(got) > 0
    assert pipeline.tonioni_mcs is pg.tonioni_mcs


def test_ransac_points_cross_matches_jax():
    b1 = planogram(3)[0]
    np.testing.assert_array_equal(pg._ransac_points_cross(b1),
                                  j_pg._ransac_points_cross(b1))


@pytest.mark.parametrize("matched_actual", [False, True])
@pytest.mark.parametrize("expected_positions", [False, True])
def test_finalize_via_ransac_cross_points_and_flags_match_jax(
        matched_actual, expected_positions):
    b1, l1, _, _ = planogram(4, violation_rate=0.0)
    # the actual shelf: every expected box moved by one affine map, a
    # third of them removed, two labels swapped
    affine = np.array([1.05, 0.97], np.float32)
    b2 = (b1.reshape(-1, 2, 2) * affine + [13.0, -7.0]).reshape(-1, 4)
    keep = np.arange(len(b1)) % 3 != 1
    b2, l2 = b2[keep].astype(np.float32), [lb for lb, k in zip(l1, keep)
                                           if k]
    l2[0], l2[1] = l2[1], l2[0]
    sol = pg.large_common_subgraph(pg.build_graph(b1, l1),
                                   pg.build_graph(b2, l2))
    kwargs = dict(return_matched_actual=matched_actual,
                  return_expected_positions=expected_positions,
                  points_fn=pg._ransac_points_cross)
    got = pg.finalize_via_ransac(sol, b1, b2, l1, l2, device="cpu",
                                 **kwargs)
    want = j_pg.finalize_via_ransac(
        sol, b1, b2, l1, l2,
        **dict(kwargs, points_fn=j_pg._ransac_points_cross))
    assert len(got) == len(want) == 4 + matched_actual + expected_positions
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w  # missing labels
        elif w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:  # projected boxes, px: f32 fits of an exact homography
            np.testing.assert_allclose(g, w, atol=1e-2)
    assert got[0].sum() > 0 and (~got[0]).sum() > 0
