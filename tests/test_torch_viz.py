"""The port's utils/viz.py against the JAX package's on the same seeded
inputs: every saver writes a PNG in both, read back equal as arrays
(tolerance: none), and `pca` equal after aligning the signs of its
columns, within 1e-4 of the largest projection (torch's and XLA's f32
SVDs; measured: 3.5e-6). `evaluate_gln(plot_out=)` in both packages, on
the same detections, writes the same files with the same pixels. Then
the training loops' sample pictures: drawn on the CPU, skipped without
matplotlib, and a render that fails does not stop the training."""
import os
import shutil

import matplotlib.image
import numpy as np
import pytest
import torch

from cvpce_tpu.eval import proposals as j_proposals
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.utils import viz as j_viz
from cvpce_tpu_torch.eval import proposals
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.train import dihe as pdihe
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train import loops
from cvpce_tpu_torch.utils import viz
from test_torch_train_dihe_loops import GEN_DOWNS, CropSet, GallerySet
from test_torch_train_gln import LOOP_CFG, LOOP_TRAIN, DetectionSet

PCA_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_train_dihe_loops.py): the
    loops' ResNet-50 and U-Net steps run beside five other test
    processes in the tier-1 run, where a thread per core oversubscribes
    the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _both(tmp_path, name, call):
    """call(module, out) with the port's viz and JAX's; the PNGs equal."""
    got, want = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    call(viz, got)
    call(j_viz, want)
    np.testing.assert_array_equal(matplotlib.image.imread(got),
                                  matplotlib.image.imread(want))


def _boxes(rng, n, size=60):
    xy = rng.uniform(0, size - 20, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(4, 20, (n, 2))], -1)


def test_pca_matches_jax_up_to_sign():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(40, 24)).astype(np.float32)
    want = j_viz.pca(emb, keepdims=3)
    for x in (emb, torch.from_numpy(emb)):
        got = viz.pca(x, keepdims=3)
        assert got.shape == want.shape == (40, 3)
        signs = np.sign((got * want).sum(0))
        np.testing.assert_allclose(got * signs, want,
                                   atol=PCA_TOL * np.abs(want).max())


def test_savers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (60, 80, 3)).astype(np.float32)
    boxes = _boxes(rng, 5)
    labels = [f"p{i}" for i in range(5)]
    _both(tmp_path, "boxes.png", lambda m, out: m.save_boxes(
        img, boxes, out, labels=labels))
    # tensors go where the JAX package takes numpy
    _both(tmp_path, "boxes_t.png", lambda m, out: m.save_boxes(
        torch.from_numpy(img) if m is viz else img,
        torch.from_numpy(boxes) if m is viz else boxes, out))
    heat = rng.uniform(0, 1, (1, 30, 40)).astype(np.float32)
    _both(tmp_path, "heat.png", lambda m, out: m.save_heatmap(heat, out))
    strip = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
             for _ in range(3)]
    _both(tmp_path, "multiple.png",
          lambda m, out: m.save_multiple(strip, out))
    _both(tmp_path, "dataset.png", lambda m, out: m.save_dataset_sample(
        [img, img[::-1]], [boxes, boxes[:2]], [labels, labels[:2]],
        strip + strip, [f"t{i}" for i in range(6)], out))
    _both(tmp_path, "treemap.png", lambda m, out: m.category_treemap(
        {"Food": 40, "Drinks": 25, "Care": 9, "Misc": 1}, out))
    _both(tmp_path, "plano.png", lambda m, out: m.draw_planogram(
        boxes, labels, out, matched=np.array([1, 0, 1, 1, 0], bool)))
    p, r = rng.uniform(0, 1, 50), np.sort(rng.uniform(0, 1, 50))
    f = 2 * p * r / (p + r)
    c = np.sort(rng.uniform(0, 1, 50))[::-1]
    _both(tmp_path, "prfc.png", lambda m, out: m.plot_prfc(
        p, r, f, c, out, title="IoU 0.5", resolution_reduction=2))


def test_embedding_scatter_matches_jax(tmp_path):
    """The scatter goes through `pca`: embeddings whose top components
    stand well apart, so both SVDs give the same points to the pixel."""
    rng = np.random.default_rng(2)
    basis = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    emb = (rng.normal(size=(30, 16)) * np.linspace(8, 1, 16)) @ basis
    emb = emb.astype(np.float32)
    _both(tmp_path, "scatter.png", lambda m, out: m.save_embedding_scatter(
        emb, out, labels=list(range(30))))
    _both(tmp_path, "scatter_fake.png",
          lambda m, out: m.save_embedding_scatter(
              emb, out, fake_embeddings=emb[:10] * 0.9))


class ScoredSet:
    """Eval items whose image carries its index, for a fixed detector."""

    def __init__(self, n=5):
        rng = np.random.default_rng(3)
        self.items = []
        for i in range(n):
            img = np.full((64, 64, 3), i, np.float32)
            gt = _boxes(rng, 4).astype(np.float32)
            self.items.append({
                "image": img, "image_size": np.array([64, 64], np.int32),
                "scale": np.float32(1.0), "orig_boxes": gt})
        self.detections = []
        for item in self.items:
            gt = item["orig_boxes"]
            boxes = np.concatenate([gt + rng.uniform(-3, 3, gt.shape),
                                    _boxes(rng, 3)]).astype(np.float32)
            self.detections.append(
                (boxes, rng.uniform(0.05, 1, len(boxes)).astype(np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def infer(self, variables, images, sizes):
        """The detections of each item, padded to 8 a batch."""
        idx = np.asarray(images)[:, 0, 0, 0].astype(int)
        boxes = np.zeros((len(idx), 8, 4), np.float32)
        scores = np.zeros((len(idx), 8), np.float32)
        valid = np.zeros((len(idx), 8), bool)
        for k, i in enumerate(idx):
            b, s = self.detections[i]
            boxes[k, :len(b)], scores[k, :len(b)] = b, s
            valid[k, :len(b)] = True
        return {"boxes": boxes, "scores": scores, "valid": valid}


def test_evaluate_gln_plots_match_jax(tmp_path):
    data = ScoredSet()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()

    def port_infer(state_dict, images, sizes):
        return {k: torch.from_numpy(v) for k, v in
                data.infer(state_dict, images.numpy(), sizes).items()}

    thresholds = (0.5, 0.75)
    got = proposals.evaluate_gln(
        {}, data, GLNConfig(), thresholds=thresholds, batch_size=2,
        plot_out=str(tmp_path / "port" / "curves.png"),
        infer_fn=port_infer, device="cpu")
    want = j_proposals.evaluate_gln(
        {}, data, JGLNConfig(), thresholds=thresholds, batch_size=2,
        plot_out=str(tmp_path / "jax" / "curves.png"), infer_fn=data.infer)
    for t in thresholds:
        assert got[t]["ap"] == pytest.approx(want[t]["ap"], abs=1e-6)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["curves_iou0.5.png", "curves_iou0.75.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        np.testing.assert_array_equal(
            matplotlib.image.imread(str(tmp_path / "port" / name)),
            matplotlib.image.imread(str(tmp_path / "jax" / name)))


# ------------------------------------------------ the loops' sample pictures

@pytest.fixture
def run_dir(tmp_path):
    """A run's directory (its GLN checkpoints are 0.3 GB each), removed
    after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _gln_loop(out):
    return loops.train_proposal_generator(
        DetectionSet(n=2), DetectionSet(n=1), str(out),
        model_cfg=GLNConfig(**LOOP_CFG),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), batch_size=1,
        epochs=1, checkpoint_interval=1, eval_interval=5, use_mesh=False,
        device="cpu")


def _pngs(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".png"))


def test_gln_loop_draws_its_samples_and_trains_on_a_failing_render(
        run_dir, monkeypatch, capsys):
    got = _gln_loop(run_dir / "ok")
    assert got["state"].step == 2
    assert _pngs(run_dir / "ok") == ["00000_gaussians.png",
                                     "00000_gt_05.png", "00001_gaussians.png",
                                     "00001_gt_05.png"]
    shape = matplotlib.image.imread(
        str(run_dir / "ok" / "00000_gaussians.png")).shape
    # the Gaussian branch's map, at stride 2
    assert shape[:2] == (LOOP_CFG["canvas_h"] // 2, LOOP_CFG["canvas_w"] // 2)

    def broken(*args, **kwargs):
        raise RuntimeError("no display")

    monkeypatch.setattr(viz, "save_boxes", broken)
    capsys.readouterr()
    got = _gln_loop(run_dir / "broken")
    assert got["state"].step == 2
    assert capsys.readouterr().out.count(
        "sample render failed: no display") == 2
    assert _pngs(run_dir / "broken") == []
    assert os.path.exists(run_dir / "broken" / "checkpoint.meta.json")


def test_loops_skip_the_render_without_matplotlib(run_dir, monkeypatch,
                                                  capsys):
    """Without matplotlib (the card's machine) the render is skipped
    before its inference: one line, no picture, the same training."""
    calls = []
    real = viz.save_heatmap
    monkeypatch.setattr(viz, "available", lambda: False)
    monkeypatch.setattr(viz, "save_heatmap",
                        lambda *a: calls.append(real(*a)))
    got = _gln_loop(run_dir / "gln")
    assert got["state"].step == 2 and not calls
    assert _pngs(run_dir / "gln") == []
    out = capsys.readouterr().out
    assert out.count("sample pictures skipped") == 1
    state = loops.pretrain_gan(
        GallerySet(4), CropSet(4), str(run_dir / "gan"), batch_size=2,
        checkpoint_interval=1, device="cpu",
        train_cfg=pdihe.GANPretrainConfig(gen_downs=GEN_DOWNS))["state"]
    assert _pngs(run_dir / "gan") == []
    assert capsys.readouterr().out.count("sample pictures skipped") == 1
    assert state.generator.training


def test_gan_loop_draws_its_samples_and_trains_on_a_failing_render(
        run_dir, monkeypatch, capsys):
    kw = dict(batch_size=2, checkpoint_interval=1, device="cpu",
              train_cfg=pdihe.GANPretrainConfig(gen_downs=GEN_DOWNS))
    loops.pretrain_gan(GallerySet(4), CropSet(4), str(run_dir / "ok"), **kw)
    assert _pngs(run_dir / "ok") == ["00000.png", "00001.png"]

    def broken(*args, **kwargs):
        raise RuntimeError("no display")

    monkeypatch.setattr(viz, "save_multiple", broken)
    capsys.readouterr()
    state = loops.pretrain_gan(GallerySet(4), CropSet(4),
                               str(run_dir / "broken"), **kw)["state"]
    assert capsys.readouterr().out.count(
        "gan sample render failed: no display") == 2
    assert _pngs(run_dir / "broken") == []
    assert state.generator.training  # put back in train mode
