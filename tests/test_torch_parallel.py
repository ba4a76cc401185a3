"""The port's data parallelism (cvpce_tpu_torch/parallel, ops/knn_sharded.py
and the `mesh=` paths) on 2 gloo ranks on the CPU, against the JAX
package's single-device result on the whole global batch, which is what
JAX computes under its mesh (tests/test_parallel_e2e.py:21): the
multihost and mesh helpers; train-mode BatchNorm over the global batch
(output, input gradient, parameter gradients, running statistics); the
Gaussian heatmap loss's global hard-negative mining, with negatives tied
across the ranks and without positives; the gallery-sharded kNN and
Classifier(mesh=) (mirroring tests/test_knn_sharded.py); and
ProposalGenerator(mesh=), evaluate_gln(mesh=) and eval_dihe(mesh=)
(mirroring tests/test_parallel_e2e.py:275,303).

Each test's ranks run in subprocesses (tests/torch_parallel_common.py)
while the test computes the JAX reference. Tolerances, stated at each
check: float64 BatchNorm within 1e-12 (the statistics' sums are
all-reduced, then divided, where flax divides each rank's mean); the
f32 loss value within 1e-6 relative and its gradient, over the rank
count, within 1e-6 of the largest (the kept pixels must be JAX's,
ties included); kNN indices and classifications equal; detections as
tests/test_parallel_e2e.py holds them (valid sets equal, scores within
1e-4, boxes within 1e-2 px) and equal to the port's own one-process
result; metrics within 1e-6, accuracies equal."""
import datetime

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.eval.classification import eval_dihe as j_eval_dihe
from cvpce_tpu.eval.proposals import evaluate_gln as j_evaluate_gln
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.ops.knn import nearest_neighbors as j_nearest_neighbors
from cvpce_tpu.ops.losses import gaussian_heatmap_loss as j_heatmap_loss
from cvpce_tpu.pipeline.classifier import Classifier as JClassifier
from cvpce_tpu.pipeline.proposals import \
    ProposalGenerator as JProposalGenerator
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.parallel import multihost
from torch_parallel_common import free_port, start_ranks

GLN_CFG = dict(canvas_h=64, canvas_w=64, max_nms_candidates=128,
               detections_per_img=64)


# ------------------------------------------------------ mesh, multihost

def test_mesh_helpers_on_two_ranks():
    got = start_ranks("mesh_helpers").results()
    for rank, out in enumerate(got):
        assert out["shard_info"] == (rank, 2)
        assert out["mesh"] == (rank, 2, "cpu")
        x, y = out["sharded"]
        np.testing.assert_array_equal(
            x, np.arange(24, dtype=np.float32).reshape(8, 3)[rank * 4:
                                                              rank * 4 + 4])
        np.testing.assert_array_equal(y, [2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(
            out["sharded_axis1"],
            np.arange(8, dtype=np.float32).reshape(2, 4)[:, 2 * rank:
                                                         2 * rank + 2])
        assert "local batch sizes differ" in out["refused"]
    # rank 0's weights and momentum on both; the metrics averaged
    for key in ("weight", "momentum"):
        np.testing.assert_array_equal(got[0]["replicated"][key],
                                      got[1]["replicated"][key])
    # rank 0's Linear after one SGD step on a gradient of ones
    torch.manual_seed(0)
    w0 = torch.nn.Linear(3, 2).weight.detach() - 0.1
    np.testing.assert_array_equal(got[1]["replicated"]["weight"],
                                  w0.numpy())
    assert got[0]["metrics"] == got[1]["metrics"]
    assert got[0]["metrics"]["rank"] == 0.5


def test_initialize_multihost_is_a_noop_alone_and_refuses_half_a_group(
        monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize_multihost(device="cpu")
    multihost.initialize_multihost(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.host_shard_info() == (0, 1)
    with pytest.raises(ValueError, match="address, a world size and a"):
        multihost.initialize_multihost(num_processes=2, process_id=0,
                                       device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize_multihost(f"tcp://127.0.0.1:{free_port()}",
                                       1, 0)
    assert not torch.distributed.is_initialized()


def test_initialize_multihost_at_world_size_one_runs_its_warmup():
    """With an address it initialises even alone, and its warm-up
    all-reduce runs; the mesh then has one rank."""
    from cvpce_tpu_torch.parallel import data_parallel_mesh

    multihost.initialize_multihost(
        f"tcp://127.0.0.1:{free_port()}", 1, 0, device="cpu",
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = data_parallel_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert multihost.host_shard_info() == (0, 1)
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        data_parallel_mesh(device="cpu")


# ------------------------------------------------------------ BatchNorm

def test_batchnorm_global_batch_matches_flax():
    """float64, batch 4 over 2 ranks: flax's BatchNorm (momentum 0.9, eps
    1e-5, the biased variance) on the whole batch; the ranks' parameter
    gradients summed are flax's."""
    rng = np.random.default_rng(0)
    c = 5
    x = rng.normal(1.0, 2.0, (4, c, 6, 7))
    x[2:] += 3.0  # the ranks' halves have other statistics
    weight, bias = rng.normal(size=c), rng.normal(size=c)
    rm, rv = rng.normal(size=c), rng.uniform(0.5, 2, c)
    grad_out = rng.normal(size=x.shape)
    ranks = start_ranks("batchnorm", x=x, weight=weight, bias=bias,
                        running_mean=rm, running_var=rv, grad_out=grad_out)
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.float64,
                           param_dtype=jnp.float64)
        variables = {"params": {"scale": weight, "bias": bias},
                     "batch_stats": {"mean": rm, "var": rv}}
        nhwc = np.transpose(x, (0, 2, 3, 1))

        def apply(params, inp):
            return bn.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            inp, mutable=["batch_stats"])

        y, stats = apply(variables["params"], nhwc)
        _, pullback = jax.vjp(lambda p, i: apply(p, i)[0],
                              variables["params"], nhwc)
        p_grad, x_grad = pullback(np.transpose(grad_out, (0, 2, 3, 1)))
        want = {"y": np.transpose(np.asarray(y), (0, 3, 1, 2)),
                "x_grad": np.transpose(np.asarray(x_grad), (0, 3, 1, 2)),
                "weight_grad": np.asarray(p_grad["scale"]),
                "bias_grad": np.asarray(p_grad["bias"]),
                "running_mean": np.asarray(stats["batch_stats"]["mean"]),
                "running_var": np.asarray(stats["batch_stats"]["var"])}
    got = ranks.results()
    for key in ("y", "x_grad"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]),
                                   want[key], rtol=0, atol=1e-12)
    for key in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(got[0][key] + got[1][key], want[key],
                                   rtol=0, atol=1e-12)
    for key in ("running_mean", "running_var"):
        for g in got:
            np.testing.assert_allclose(g[key], want[key], rtol=0,
                                       atol=1e-12)


# ----------------------------------------------------- the Gaussian loss

def _loss_cases():
    """(predictions (2, 12, 16, 1), targets, kwargs) f32: random with
    positives; negatives tied across the ranks with the cut inside the
    tie group; no positives at all."""
    rng = np.random.default_rng(1)
    shape = (2, 12, 16, 1)
    pred = rng.uniform(-1, 1, shape).astype(np.float32)
    tgt = np.where(rng.uniform(size=shape) < 0.1,
                   rng.uniform(0.1, 1, shape),
                   np.where(rng.uniform(size=shape) < 0.5, -1.0, 0.0))
    random = (pred, tgt.astype(np.float32),
              dict(tanh=True, min_negatives=40))

    # the same image on both ranks: 6 positives an image, the negatives'
    # errors in three tie groups of 0.09, 0.04 and 0.01; n_top =
    # 3 x 12 = 36 ends inside the 0.04 group, which spans both ranks
    one_t = np.zeros((1, 12, 16, 1), np.float32)
    one_t.reshape(-1)[:6] = 0.5
    one_p = np.zeros_like(one_t)
    flat = one_p.reshape(-1)
    flat[:6] = 0.5
    flat[6:16] = 0.3   # 10 errors of 0.09 an image
    flat[16:46] = 0.2  # 30 of 0.04
    flat[46:] = 0.1
    ties = (np.concatenate([one_p, one_p]), np.concatenate([one_t, one_t]),
            dict(min_negatives=8))

    nopos = (pred, np.where(tgt > 0, 0.0, tgt).astype(np.float32),
             dict(tanh=True, min_negatives=50))
    return {"random": random, "ties": ties, "no_positives": nopos}


def test_gaussian_loss_mines_the_global_batch():
    cases = _loss_cases()
    ranks = start_ranks("heatmap_loss", cases=list(cases.values()))
    want = {}
    for name, (pred, tgt, kw) in cases.items():
        value, grad = jax.value_and_grad(
            lambda p: j_heatmap_loss(p, tgt, **kw))(pred)
        want[name] = (float(value), np.asarray(grad))
    got = ranks.results()
    for i, name in enumerate(cases):
        value, grad = want[name]
        g_grad = np.concatenate([g[i][1] for g in got]) / 2
        for g in got:  # the global loss on every rank
            assert g[i][0] == pytest.approx(value, rel=1e-6), name
        np.testing.assert_allclose(g_grad, grad, rtol=0,
                                   atol=1e-6 * np.abs(grad).max(),
                                   err_msg=name)
        if name == "ties":
            # 36 kept: 10 + 10 of 0.09, then 16 of the 0.04 group, all of
            # them rank 0's (the lowest global index)
            kept0 = (got[0][i][1] != 0).reshape(-1)
            kept1 = (got[1][i][1] != 0).reshape(-1)
            assert kept0[16:46].sum() == 16 and kept0[16:32].all()
            assert kept1[16:46].sum() == 0


# ------------------------------------------------------------- the kNN

def _knn_cases():
    rng = np.random.default_rng(0)
    random = (rng.normal(size=(101, 64)).astype(np.float32),
              rng.normal(size=(17, 64)).astype(np.float32), 3)
    base = rng.normal(size=(16, 32)).astype(np.float32)
    # rows i and i + 16 identical and on different ranks
    ties = (np.concatenate([base, base]), base[:5] + 0.0, 2)
    few = (rng.normal(size=(9, 16)).astype(np.float32),
           rng.normal(size=(4, 16)).astype(np.float32), 9)
    # blocks of 4097 rows (the last row a pad): each rank's valid prefix
    # takes the fused route; row 4100 (rank 1) repeats row 5 (rank 0)
    big = rng.normal(size=(8193, 16)).astype(np.float32)
    big[4100] = big[5]
    large = (big, np.concatenate([big[[5, 4100, 8192]],
                                  rng.normal(size=(6, 16))]).astype(
                                      np.float32), 8)
    return {"random": random, "ties": ties, "few": few, "large": large}


def test_sharded_knn_matches_single_search():
    cases = _knn_cases()
    rng = np.random.default_rng(3)
    anchors = rng.normal(size=(64, 32)).astype(np.float32)
    queries = [np.random.default_rng(s).normal(size=(8, 32)).astype(
        np.float32) for s in (4, 5)]
    ranks = start_ranks("sharded_knn", cases=list(cases.values()),
                        reuse=(anchors, queries, 4))
    want = [np.asarray(j_nearest_neighbors(a, q, k=k))
            for a, q, k in cases.values()]
    want_reuse = [np.asarray(j_nearest_neighbors(anchors, q, k=4))
                  for q in queries]
    got = ranks.results()
    for out in got:
        for name, g, w in zip(cases, out["cases"], want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert (out["cases"][1][:, 0] == np.arange(5)).all()  # lowest
        assert out["cases"][2].max() < 9  # no pad row surfaces
        assert (out["cases"][3][:2, 0] == 5).all()
        for (d, i), w in zip(out["reuse"], want_reuse):
            np.testing.assert_array_equal(i, w)
            assert (np.diff(d, axis=1) >= 0).all()
        assert out["prepared_once"] and not out["fused_block"]


def test_nearest_neighbors_masked_matches_jax():
    """ops/knn.py:nearest_neighbors_masked on a padded gallery: invalid
    rows (one of them a copy of a valid row) never surface, ties go to
    the lowest index."""
    from cvpce_tpu.ops.knn import nearest_neighbors_masked as j_masked
    from cvpce_tpu_torch.ops.knn import nearest_neighbors_masked

    rng = np.random.default_rng(6)
    anchors = rng.normal(size=(12, 16)).astype(np.float32)
    anchors[7] = anchors[2]
    anchors[10] = anchors[4]
    valid = np.ones(12, bool)
    valid[[1, 2, 11]] = False
    queries = np.concatenate([anchors[[2, 4]], rng.normal(size=(5, 16))]
                             ).astype(np.float32)
    got = nearest_neighbors_masked(torch.from_numpy(anchors),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(queries), k=9).numpy()
    want = np.asarray(j_masked(anchors, valid, queries, k=9))
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, [1, 2, 11]).any()
    assert got[0, 0] == 7 and got[1, 0] == 4


def _color_gallery(n=10):
    """(img, img, label, label) items of flat-colour 256 px images; items
    n - 2 and n - 1 repeat items 1 and 3 (other labels, later rows)."""
    rng = np.random.default_rng(2)
    colors = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    colors[n - 2], colors[n - 1] = colors[1], colors[3]
    items = []
    for i, c in enumerate(colors):
        img = np.broadcast_to(c, (256, 256, 3)).copy()
        items.append((img, img, f"p{i}", f"p{i}"))
    return items, colors


def j_color_encoder(images):
    b = images.shape[0]
    return jnp.asarray(images).reshape(b, 4, 64, 4, 64, 3).mean(
        axis=(2, 4)).reshape(b, 48)


def test_classifier_mesh_matches_jax():
    items, colors = _color_gallery()
    rng = np.random.default_rng(7)
    queries = [np.stack([np.broadcast_to(colors[i], (256, 256, 3))
                         + rng.normal(0, 0.02, (256, 256, 3))
                         for i in picks]).astype(np.float32)
               for picks in ((3, 0, 6, 5, 1), (9, 8, 2))]
    ranks = start_ranks("classifier", gallery_items=items, queries=queries,
                        k=2)
    clf = JClassifier(j_color_encoder, 48, items, batch_size=4, k=2)
    want = [clf.classify(q) for q in queries]
    got = ranks.results()
    for out in got:
        assert out["mesh"] == out["plain"] == want
        assert out["block_rows"] == 5
    assert want[0][4][0] == "p1" and want[1][0][0] == "p3"  # lowest row


# ----------------------------------------------------- serving and eval

def detection_items(n=8, canvas=64):
    """Eval items (tests/test_torch_train_gln.py's DetectionSet): 2-4
    small boxes and one large one each, which a random detector's
    anchors find at IoU 0.5."""
    rng = np.random.default_rng(0)
    items = []
    for _ in range(n):
        img = rng.uniform(0, 1, (canvas, canvas, 3)).astype(np.float32)
        nb = int(rng.integers(2, 5))
        xy = rng.uniform(0, canvas - 20, (nb, 2)).astype(np.float32)
        wh = rng.uniform(8, 18, (nb, 2)).astype(np.float32)
        boxes = np.concatenate([np.concatenate([xy, xy + wh], -1),
                                np.float32([[2, 3, 61, 60]])])
        items.append({"image": img, "boxes": boxes,
                      "image_size": np.array([canvas, canvas], np.int32),
                      "scale": np.float32(1.0), "orig_boxes": boxes})
    return items


def assert_same_metrics(a, b):
    """Equal metric dicts, their raw curves included."""
    assert a.keys() == b.keys()
    for key in a:
        if key == "raw":
            assert a[key].keys() == b[key].keys()
            for k in a[key]:
                np.testing.assert_array_equal(a[key][k], b[key][k])
        else:
            assert a[key] == b[key], key


def test_proposals_and_evaluate_gln_mesh_match_jax(tmp_path):
    """A seeded reference-layout GLN checkpoint (whose detections find the
    large boxes; a PRNGKey init finds none), loaded by each package's
    loader."""
    from cvpce_tpu.cli.common import load_gln_variables

    path = str(tmp_path / "gln_reference.pth")
    torch.save({"model_state_dict": testing.gln_reference_state_dict(
        np.random.default_rng(5))}, path)
    rng = np.random.default_rng(1)
    # aspect ratios give per-image canvas scales; 5 images over 2 ranks
    # pad to 6 and drop the pad's results
    images = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
              for h, w in ((96, 96), (48, 80), (80, 48), (64, 64),
                           (100, 60))]
    dataset = detection_items()
    eval_kw = dict(thresholds=(0.5,), batch_size=4, score_min=0.0)
    ranks = start_ranks("serving", checkpoint=path, config_kw=GLN_CFG,
                        images=images, dataset=dataset, eval_kw=eval_kw)
    cfg = JGLNConfig(**GLN_CFG)
    variables = jax.device_get(load_gln_variables(path, cfg))
    single = JProposalGenerator(variables, cfg, confidence_threshold=0.0)
    want_det = [single.detect(img) for img in images]
    want_eval = j_evaluate_gln(variables, dataset, cfg, **eval_kw)[0.5]
    assert want_eval["ap"] > 0
    got = ranks.results()
    for out in got:
        assert len(out["detect_mesh"]) == len(images)
        for g, s, w in zip(out["detect_mesh"], out["detect_single"],
                           want_det):
            for key in ("valid", "scores", "boxes"):
                np.testing.assert_array_equal(g[key], s[key])
            np.testing.assert_array_equal(g["valid"], w["valid"])
            keep = w["valid"]
            np.testing.assert_allclose(g["scores"][keep],
                                       w["scores"][keep], rtol=0, atol=1e-4)
            np.testing.assert_allclose(g["boxes"][keep], w["boxes"][keep],
                                       rtol=0, atol=1e-2)
        metrics = out["eval_mesh"][0.5]
        assert_same_metrics(metrics, out["eval_single"][0.5])
        assert_same_metrics(metrics, got[0]["eval_mesh"][0.5])
        for key in ("ap", "ar_300", "f", "p", "r"):
            assert float(metrics[key]) == pytest.approx(
                float(want_eval[key]), abs=1e-6), key


def test_eval_dihe_mesh_matches_jax():
    items, colors = _color_gallery()
    rng = np.random.default_rng(4)
    testset = []
    for picks in ((0, 3, 5, 9), (8, 2, 7, 1), (4, 6, 1, 3)):
        img = np.concatenate([np.broadcast_to((colors[i] + 1) / 2,
                                              (64, 64, 3)) for i in picks],
                             axis=1)
        img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)
        boxes = np.array([[k * 64, 0, (k + 1) * 64, 64] for k in range(4)],
                         np.float32)
        testset.append((img.astype(np.float32), [f"p{i}" for i in picks],
                        boxes))
    ranks = start_ranks("dihe_eval", gallery_items=items, testset=testset,
                        k=(1, 2))
    want = j_eval_dihe(j_color_encoder, 48, items, testset, batch_size=4,
                       k=(1, 2), verbose=False)
    got = ranks.results()
    for out in got:
        assert out["mesh"] == out["single"] == {k: float(v)
                                                for k, v in want.items()}
