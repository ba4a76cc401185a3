"""The port's dataset readers against the JAX package's on the same
files: the layouts of tests/test_data.py's fixtures (and the other
datasets' own layouts) with seeded PNG images written under the
datasets' names (`.jpg` included: both decoders go by the signature).

Tolerances: the index, names, boxes, labels, annotations, hierarchies,
graphs and every numpy rng draw (flips, crops) are equal; decoded images
are equal; images that went through a resize are within 5e-5 of cv2's
INTER_LINEAR (the measured bound of tests/test_torch_transforms.py),
scaled by the ImageNet normalisation (/ 0.224) or the tanh range (x 2)
where those follow."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from cvpce_tpu.data import coco as j_coco
from cvpce_tpu.data import grocery as j_gp
from cvpce_tpu.data import grozi as j_grozi
from cvpce_tpu.data import planograms as j_plano
from cvpce_tpu.data import sku110k as j_sku
from cvpce_tpu_torch import data
from cvpce_tpu_torch.data import coco, defaults, grocery, grozi, planograms
from cvpce_tpu_torch.data import sku110k
from cvpce_tpu_torch.testing import write_png

RESIZE_TOL = 5e-5


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _image(path, rng, h, w, c=3):
    arr = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    write_png(path, arr)
    return arr


def test_names_of_the_jax_data_package():
    import cvpce_tpu.data as j_data
    from cvpce_tpu.data import defaults as j_defaults

    public = {n for n in dir(j_data) if not n.startswith("_")}
    assert public <= set(dir(data)), sorted(public - set(dir(data)))
    for name in dir(j_defaults):
        if name.isupper():
            assert getattr(defaults, name) == getattr(j_defaults, name)


# ---------------------------------------------------------------- SKU-110K

@pytest.fixture
def sku(tmp_path):
    """tests/test_data.py's layout, PNG bytes under .jpg names, a
    malformed row and a name on the skip list."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for name, (w, h), n_boxes in [("a.jpg", (100, 80), 3),
                                  ("b.jpg", (60, 120), 2),
                                  ("train_882.jpg", (50, 50), 1),
                                  ("c.jpg", (90, 70), 4)]:
        _image(img_dir / name, rng, h, w)
        for _ in range(n_boxes):
            x1 = int(rng.integers(0, w - 20))
            y1 = int(rng.integers(0, h - 20))
            rows.append(f"{name},{x1},{y1},{x1 + 15},{y1 + 15},object,{w},{h}")
    rows.insert(2, "malformed,row")
    ann = tmp_path / "ann.csv"
    ann.write_text("\n".join(rows) + "\n")
    return str(img_dir), str(ann)


def _same_item(got, want, norm=0.224):
    np.testing.assert_allclose(_np(got["image"]), want["image"],
                               atol=RESIZE_TOL / norm)
    for key in ("boxes", "image_size", "scale", "orig_boxes", "orig_size"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["name"] == want["name"]


def test_sku110k_index_items_and_flips(sku):
    img_dir, ann = sku
    kw = dict(skip=defaults.SKU110K_SKIP, canvas_h=128, canvas_w=160,
              seed=4)
    got = sku110k.SKU110KDataset(img_dir, ann, **kw)
    want = j_sku.SKU110KDataset(img_dir, ann, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got.index, want.index):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert got.index_for_name("c.jpg") == want.index_for_name("c.jpg") == 2
    for i in (0, 1, 2, 0, 2, 1, 1, 0):  # the 50% flips: the same draws
        _same_item(got[i], want[i])
    assert got.rng.random() == want.rng.random()
    batch = sku110k.collate_detection([got[0], got[2]], box_bucket=64)
    wbatch = j_sku.collate_detection([want[0], want[2]], box_bucket=64)
    for k in ("boxes", "box_valid", "image_sizes"):
        np.testing.assert_array_equal(batch[k], wbatch[k])
    np.testing.assert_allclose(_np(batch["images"]), wbatch["images"],
                               atol=RESIZE_TOL / 0.224)


def test_target_domain_crops(sku):
    img_dir, ann = sku
    got = sku110k.TargetDomainDataset(img_dir, ann)
    want = j_sku.TargetDomainDataset(img_dir, ann)
    assert len(got) == len(want) == 10
    for i in range(len(got)):
        np.testing.assert_allclose(_np(got[i]), want[i], atol=RESIZE_TOL)


def test_sku110k_refuses_jpeg_and_falls_back_on_a_broken_png(sku):
    img_dir, ann = sku
    jpeg = os.path.join(img_dir, "b.jpg")
    Image.open(jpeg).convert("RGB").save(jpeg, format="JPEG")
    kw = dict(flip_chance=0.0, canvas_h=128, canvas_w=160)
    got = sku110k.SKU110KDataset(img_dir, ann, **kw)
    want = j_sku.SKU110KDataset(img_dir, ann, **kw)
    assert want[1]["name"] == "b.jpg"  # PIL reads it
    with pytest.raises(NotImplementedError, match="b.jpg"):
        got[1]
    cut = os.path.join(img_dir, "c.jpg")
    with open(cut, "rb") as f:
        head = f.read(100)
    with open(cut, "wb") as f:
        f.write(head)
    # a truncated file is an OSError in both: item 0 comes back instead
    assert got[3]["name"] == want[3]["name"] == "a.jpg"


# --------------------------------------------------------- Grocery Products

@pytest.fixture
def gp_train(tmp_path):
    """Training/<category>/<sub>/<n>.jpg with a Background tree, an
    Originals folder, index junk and a nonconforming name, and beside
    Training/ the TrainingFiles.txt index; white-ground product photos
    for the masks."""
    root = tmp_path / "Training"
    rng = np.random.default_rng(1)
    files = []
    for cat, sub, n in [("Food", "Bakery", 3), ("Food", "Dairy", 2),
                        ("Drinks", "Juice", 2)]:
        d = root / cat / sub
        d.mkdir(parents=True)
        for i in range(1, n + 1):
            h, w = int(rng.integers(20, 40)), int(rng.integers(20, 40))
            arr = np.full((h, w, 3), 255, np.uint8)
            arr[4:-4, 4:-4] = rng.integers(0, 200, (h - 8, w - 8, 3))
            write_png(d / f"{i}.jpg", arr)
            files.append(f"Training/{cat}/{sub}/{i}.jpg")
    (root / "Background" / "x").mkdir(parents=True)
    _image(root / "Background" / "x" / "1.jpg", rng, 8, 8)
    (root / "Food" / "Bakery" / "Originals").mkdir()
    _image(root / "Food" / "Bakery" / "Originals" / "9.jpg", rng, 8, 8)
    (root / "Food" / "Thumbs.db").write_bytes(b"junk")
    (root / "Food" / "noext").write_bytes(b"junk")
    (tmp_path / "TrainingFiles.txt").write_text("\n".join(files) + "\n")
    return str(root)


def _same_gp_items(got, want, n, tanh=True):
    tol = (2.0 if tanh else 1.0) * RESIZE_TOL
    for i in range(n):
        g, w = got[i], want[i]
        assert len(g) == len(w)
        np.testing.assert_allclose(_np(g[0]), w[0], atol=tol)
        np.testing.assert_allclose(_np(g[1]), w[1], atol=tol)
        assert g[2:] == w[2:]


@pytest.mark.parametrize("from_file", [False, True])
def test_grocery_products_index_and_crops(gp_train, from_file):
    root = os.path.dirname(gp_train) if from_file else gp_train
    kw = dict(include_annotations=True, index_from_file=from_file, seed=6)
    got = grocery.GroceryProductsDataset([root], **kw)
    want = j_gp.GroceryProductsDataset([root], **kw)
    assert got.paths == want.paths and len(got) == 7
    assert got.categories == want.categories
    assert got.annotations == want.annotations
    assert got.index_for_ann(want.annotations[3]) == 3
    _same_gp_items(got, want, len(got))  # random crops: the same draws
    only = grocery.GroceryProductsDataset([root], only=["Drinks"],
                                          index_from_file=from_file)
    assert only.paths == j_gp.GroceryProductsDataset(
        [root], only=["Drinks"], index_from_file=from_file).paths


def test_grocery_products_masks_and_unresized(gp_train):
    kw = dict(random_crop=False, include_masks=True)
    got = grocery.GroceryProductsDataset([gp_train], **kw)
    want = j_gp.GroceryProductsDataset([gp_train], **kw)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g[1].shape == w[1].shape == (256, 256, 4)
        np.testing.assert_allclose(_np(g[1]), w[1], atol=2 * RESIZE_TOL)
        assert _np(g[1])[..., 3].min() < 0.5 < _np(g[1])[..., 3].max()
    raw = grocery.GroceryProductsDataset([gp_train], random_crop=False,
                                         resize=False)
    wraw = j_gp.GroceryProductsDataset([gp_train], random_crop=False,
                                       resize=False)
    np.testing.assert_array_equal(_np(raw[2][0]), wraw[2][0])


def test_internal_trainset_on_rgba_pngs(tmp_path):
    rng = np.random.default_rng(2)
    for face in ("front", "back"):
        for code in ("1001", "1002"):
            d = tmp_path / "shelf" / code / face
            d.mkdir(parents=True)
            arr = rng.integers(0, 256, (24, 18, 4), dtype=np.uint8)
            arr[:4, :, 3] = 0
            write_png(d / f"{code}.png", arr)
    (tmp_path / "Unknown").mkdir()
    _image(tmp_path / "Unknown" / "7.png", rng, 8, 8, 4)
    kw = dict(include_annotations=True, include_masks=True, seed=3)
    got = grocery.InternalTrainSet(str(tmp_path), **kw)
    want = j_gp.InternalTrainSet(str(tmp_path), **kw)
    assert got.paths == want.paths and len(got) == 4
    assert got.annotations == want.annotations
    for ann in ("1001", "1002"):
        assert got.index_for_ann(ann) == want.index_for_ann(ann)
        assert "front" in got.categories[got.index_for_ann(ann)]
    _same_gp_items(got, want, len(got))


def test_simple_folder_set(tmp_path):
    rng = np.random.default_rng(3)
    for name in ("b.png", "a.jpg", "c.jpeg", "notes.txt"):
        _image(tmp_path / name, rng, 12, 20)
    for train in (True, False):
        got = grocery.SimpleFolderSet(str(tmp_path), train=train)
        want = j_gp.SimpleFolderSet(str(tmp_path), train=train)
        assert got.classes == want.classes == ["a", "b", "c"]
        assert got.index_for_ann("c") == 2
        for i in range(len(got)):
            g, w = got[i], want[i]
            np.testing.assert_allclose(_np(g[0]), w[0], atol=RESIZE_TOL)
            assert g[2:] == w[2:]


@pytest.fixture
def gp_test(tmp_path):
    """tests/test_data.py's GP-180 layout, two stores, with Tonioni
    planograms for the first two scenes."""
    ann_dir = tmp_path / "ann"
    ann_dir.mkdir()
    (ann_dir / "s1_2.csv").write_text(
        "Food/Bakery/p1.jpg, 10, 20, 50, 80\n"
        "Food/Dairy/p2.jpg, 60, 20, 90, 80\n"
        "bad,row\n"
        "Food/Dairy/p3.png, 1, 2, 3, 4\n")
    (ann_dir / "s3_11.csv").write_text(
        "Drinks/Juice/j1.jpg, 5, 5, 40, 60\n")
    (ann_dir / "notes.txt").write_text("x")
    img_dir = tmp_path / "imgs"
    rng = np.random.default_rng(4)
    for s, i, hw in (("1", "2", (100, 120)), ("3", "11", (90, 70))):
        (img_dir / f"store{s}" / "images").mkdir(parents=True)
        _image(img_dir / f"store{s}" / "images" / f"store{s}_{i}.jpg", rng,
               *hw)
    plano_dir = tmp_path / "planos"
    plano_dir.mkdir()
    (plano_dir / "s1_2.json").write_text(json.dumps(_grid_planogram(2, 3)))
    (plano_dir / "s3_11.json").write_text(json.dumps(_grid_planogram(3, 2)))
    return str(img_dir), str(ann_dir), str(plano_dir)


def test_gp_test_set(gp_test):
    img_dir, ann_dir, _ = gp_test
    for kw in ({}, {"only": 1}, {"skip": 1}, {"only": ["s3_11.csv"]},
               {"skip": ["s3_11.csv"]}):
        got = grocery.GroceryProductsTestSet(img_dir, ann_dir, **kw)
        want = j_gp.GroceryProductsTestSet(img_dir, ann_dir, **kw)
        assert got.int_to_ann == want.int_to_ann
        assert got.ann_to_int == want.ann_to_int
        assert len(got) == len(want)
        for i in range(len(got)):
            g, w = got[i], want[i]
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[2], w[2])
    got = grocery.GroceryProductsTestSet(img_dir, ann_dir)
    assert got.get_index_for("3", "11") == 1
    assert got.get_index_for("3", "12") is None


def test_gp_baseline_dataset(tmp_path, gp_test):
    img_dir = gp_test[0]
    csv = tmp_path / "baseline.csv"
    csv.write_text("name,x1,y1,x2,y2,label\n"
                   "store1_2.jpg,1,2,30,40,x\n"
                   "store3_11.jpg,5,6,20,30,y\n"
                   "store1_2.jpg,10,12,50,60,x\n"
                   "short,row\n"
                   "nostore.jpg,1,2,3,4,z\n")
    got = grocery.GPBaselineDataset(img_dir, str(csv))
    want = j_gp.GPBaselineDataset(img_dir, str(csv))
    assert len(got) == len(want) == 2
    for i in range(2):
        assert got.index[i]["image_path"] == want.index[i]["image_path"]
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- planograms

def _grid_planogram(rows, cols, seed=0):
    """A Tonioni JSON grid of rows x cols products (n/s/e/w neighbour
    indices, -1 for none), ragged product sizes."""
    rng = np.random.default_rng((seed, rows, cols))
    graph = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            graph.append({"ogg": int(rng.integers(0, 3)),
                          "n": i - cols if r else -1,
                          "s": i + cols if r < rows - 1 else -1,
                          "e": i + 1 if c < cols - 1 else -1,
                          "w": i - 1 if c else -1})
    objects = [{"width": float(rng.integers(2, 9)),
                "height": float(rng.integers(3, 11)),
                "img_path": f"Food/Cat{k}/prod{k}.jpg"} for k in range(3)]
    return {"graph": graph, "objects": objects}


def _same_graph(g, jg):
    assert list(g.nodes) == list(jg.nodes)
    assert {n: g.nodes[n]["label"] for n in g} == \
        {n: jg.nodes[n]["label"] for n in jg.nodes}
    assert {(u, v, g[u][v]["dir"]) for u in g for v in g[u]} == \
        {(u, v, d["dir"]) for u, v, d in jg.edges(data=True)}


@pytest.mark.parametrize("shape", [(2, 2), (3, 4), (1, 5)])
def test_read_tonioni_planogram(tmp_path, shape):
    path = tmp_path / "plano.json"
    path.write_text(json.dumps(_grid_planogram(*shape, seed=1)))
    boxes, labels, g = planograms.read_tonioni_planogram(str(path))
    jboxes, jlabels, jg = j_plano.read_tonioni_planogram(str(path))
    np.testing.assert_array_equal(boxes, jboxes)
    assert labels == jlabels
    _same_graph(g, jg)


def test_planogram_test_set(gp_test):
    got = planograms.PlanogramTestSet(*gp_test)
    want = j_plano.PlanogramTestSet(*gp_test)
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3]["boxes"], w[3]["boxes"])
        assert g[3]["labels"] == w[3]["labels"]
        assert g[3]["actual_accuracy"] == w[3]["actual_accuracy"] == 1.0
        _same_graph(g[3]["graph"], w[3]["graph"])


def test_internal_plano_set(tmp_path):
    rng = np.random.default_rng(5)
    index = []
    for k in range(2):
        _image(tmp_path / f"img{k}.png", rng, 30, 40)
        plano = [{"code": f"c{j}", "box": rng.integers(0, 50, 4).tolist()}
                 for j in range(3 + k)]
        (tmp_path / f"plano{k}.json").write_text(json.dumps(plano))
        index.append({"image": f"img{k}.png", "planogram": f"plano{k}.json",
                      "correct": 2 + k, "facings": 5})
    (tmp_path / "index.json").write_text(json.dumps(index))
    got = planograms.InternalPlanoSet(str(tmp_path))
    want = j_plano.InternalPlanoSet(str(tmp_path))
    for i in range(2):
        (g_img, g), (w_img, w) = got[i], want[i]
        np.testing.assert_array_equal(g_img, w_img)
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        assert g["labels"] == w["labels"]
        assert g["actual_accuracy"] == w["actual_accuracy"]


# ------------------------------------------------------------- GroZi, COCO

@pytest.fixture
def grozi_root(tmp_path):
    rng = np.random.default_rng(6)
    for p in (1, 2):
        web = tmp_path / "inVitro" / str(p) / "web" / "JPEG"
        web.mkdir(parents=True)
        for k in range(p + 1):
            _image(web / f"web{k}.jpg", rng, 10 + k, 12)
        (web / "readme.txt").write_text("x")
        situ = tmp_path / "inSitu" / str(p)
        situ.mkdir(parents=True)
        (situ / "coordinates.txt").write_text(
            f"1\t{4 + p}\t3\t4\t10\t12\n2\t7\t1\t2\t5\t6\n1\t9\t0\t0\t3\t3\n")
    for p in range(3, 121):  # GroZiTestSet reads all 120 products
        situ = tmp_path / "inSitu" / str(p)
        situ.mkdir(parents=True)
        (situ / "coordinates.txt").write_text("")
    ext = tmp_path / "extracted"
    ext.mkdir()
    names = ["1_5.jpg", "1_6.jpg", "2_7.jpg"]
    for name in names:
        _image(ext / name, rng, 24, 32)
    (ext / "index.txt").write_text("\n".join(names) + "\n")
    return str(tmp_path)


def test_grozi_sets(grozi_root):
    got = grozi.GroZiDataset(grozi_root, products=2)
    want = j_grozi.GroZiDataset(grozi_root, products=2)
    assert got.index == want.index and len(got) == 5
    assert got.index_for_ann(2) == want.index_for_ann(2) == 2
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]
    assert list(grozi.iter_grozi_annotations(grozi_root, 2)) == list(
        j_grozi.iter_grozi_annotations(grozi_root, 2))
    assert grozi.extracted_img_name(3, 14) == \
        j_grozi.extracted_img_name(3, 14)
    gt = grozi.GroZiTestSet(grozi_root)
    wt = j_grozi.GroZiTestSet(grozi_root)
    assert gt.most_annotated() == wt.most_annotated()
    assert gt.least_annotated() == wt.least_annotated()
    for i in range(len(gt)):
        for g, w in zip(gt[i], wt[i]):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError, match="cv2.VideoCapture"):
        grozi.extract_grozi_test_imgs(grozi_root, products=2)


def test_coco_detection_dataset(tmp_path):
    rng = np.random.default_rng(7)
    for k in range(2):
        _image(tmp_path / f"im{k}.jpg", rng, 20, 30)
    spec = {"images": [{"id": 7, "file_name": "im0.jpg", "width": 30,
                        "height": 20},
                       {"id": 3, "file_name": "im1.jpg", "width": 30,
                        "height": 20}],
            "annotations": [
                {"image_id": 7, "bbox": [1, 2, 5, 6], "category_id": 1},
                {"image_id": 3, "bbox": [0, 0, 9, 9], "category_id": 2},
                {"image_id": 7, "bbox": [4, 4, 2, 2], "category_id": 2,
                 "iscrowd": 1},
                {"image_id": 99, "bbox": [0, 0, 1, 1], "category_id": 1},
                {"image_id": 7, "bbox": [3, 1, 4, 4], "category_id": 2}],
            "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(spec))
    got = coco.CocoDetectionDataset(str(tmp_path), str(ann))
    want = j_coco.CocoDetectionDataset(str(tmp_path), str(ann))
    assert got.categories == want.categories
    assert len(got) == len(want) == 2
    for i in range(2):
        (gi, ge), (wi, we) = got[i], want[i]
        np.testing.assert_array_equal(gi, wi)
        assert ge.keys() == we.keys()
        for k in ge:
            np.testing.assert_array_equal(ge[k], we[k])
