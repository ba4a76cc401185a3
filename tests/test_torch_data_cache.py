"""The port's record cache (csrc/record_cache.cpp, a byte copy of the
JAX package's reader) and its GrainLoader against the JAX package's.

The record cache: the file the port writes from the same items is byte
for byte JAX's, and both read the same batches back (equal). GrainLoader:
the order is a pure function of (seed, epoch, shard), shards partition
each epoch, `iter_from` gives the epoch's tail, `iterator` resumes from
its state, `_resume_position` treats it as JAX's treats grain's; its
order is the port's PrefetchLoader's, not grain's (which the port cannot
reproduce). The GLN loop resumed inside an epoch with
`loader_cls=GrainLoader` gives the uninterrupted run's state and losses
bit for bit (64x64 GLN, one torch thread)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from cvpce_tpu.data import cache as j_cache
from cvpce_tpu.data.grain_loader import GrainLoader as JGrainLoader
from cvpce_tpu_torch.data import cache, sku110k
from cvpce_tpu_torch.data.grain_loader import GrainLoader
from cvpce_tpu_torch.data.loader import PrefetchLoader
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.testing import write_png
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train import loops


class _DetectionItems:
    """Canvas items with 1-4 boxes; tensor images when `tensors`."""

    def __init__(self, n=6, h=32, w=48, tensors=False):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            img = rng.uniform(size=(h, w, 3)).astype(np.float32)
            nb = int(rng.integers(1, 5))
            self.items.append({
                "image": torch.from_numpy(img) if tensors else img,
                "boxes": rng.uniform(0, 30, (nb, 4)).astype(np.float32),
                "image_size": np.array([h, w - nb], np.int32),
                "scale": np.float32(0.5 + nb)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_record_cache_file_is_jax_byte_for_byte(tmp_path):
    spec = {"a": ((4, 4), np.float32), "b": ((3,), np.int32),
            "c": ((2,), np.bool_)}
    rng = np.random.default_rng(1)
    recs = [{"a": rng.uniform(size=(4, 4)).astype(np.float32),
             "b": rng.integers(0, 100, 3).astype(np.int32),
             "c": rng.uniform(size=2) < 0.5} for _ in range(10)]
    paths = {}
    for name, mod in (("port", cache), ("jax", j_cache)):
        paths[name] = str(tmp_path / f"{name}.bin")
        rc = mod.RecordCache(paths[name], spec)
        rc.build(recs, lambda i: recs[i], verbose=False)
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    port = cache.RecordCache(paths["jax"], spec)
    port.open()
    jax = j_cache.RecordCache(paths["port"], spec)
    jax.open()
    assert len(port) == len(jax) == 10
    got, want = port.read_batch([3, 7, 0, 3]), jax.read_batch([3, 7, 0, 3])
    for k in spec:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k][1], recs[7][k])
    with pytest.raises(IndexError):
        port.read_batch([10])
    port.close()
    jax.close()
    assert cache.native_available()


def test_cached_detection_dataset_matches_jax(tmp_path):
    port = cache.CachedDetectionDataset(
        _DetectionItems(tensors=True), str(tmp_path / "p.bin"),
        box_bucket=8, verbose=False)
    jax = j_cache.CachedDetectionDataset(
        _DetectionItems(), str(tmp_path / "j.bin"), box_bucket=8,
        verbose=False)
    with open(tmp_path / "p.bin", "rb") as f, \
            open(tmp_path / "j.bin", "rb") as g:
        assert f.read() == g.read()
    assert len(port) == len(jax) == 6
    got, want = port.read_batch([5, 0, 2]), jax.read_batch([5, 0, 2])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    one = port[2]
    for k in one:
        np.testing.assert_array_equal(one[k], want[k][2])


def test_cached_sku110k_batches_are_the_datasets(tmp_path):
    """Over the port's SKU110KDataset on PNG files: the cache's batches
    equal collate_detection of the dataset's own items."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(2)
    rows = []
    for k, (h, w) in enumerate([(40, 60), (70, 50), (45, 45)]):
        write_png(img_dir / f"i{k}.jpg",
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for _ in range(k + 1):
            rows.append(f"i{k}.jpg,1,2,{w - 3},{h - 5},object,{w},{h}")
    (tmp_path / "ann.csv").write_text("\n".join(rows) + "\n")
    ds = sku110k.SKU110KDataset(str(img_dir), str(tmp_path / "ann.csv"),
                                flip_chance=0.0, canvas_h=64, canvas_w=96)
    cached = cache.CachedDetectionDataset(ds, str(tmp_path / "c.bin"),
                                          box_bucket=768, verbose=False)
    got = cached.read_batch([2, 0])
    want = sku110k.collate_detection([ds[2], ds[0]])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))


# ------------------------------------------------------------ GrainLoader

class _Ints:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return int(i)


def _collate(items):
    return list(items)


def test_grain_loader_order_shards_and_tail():
    a = GrainLoader(_Ints(23), 4, _collate, seed=5)
    b = GrainLoader(_Ints(23), 4, _collate, seed=5)
    p = PrefetchLoader(_Ints(23), 4, _collate, seed=5)
    for e in range(2):
        for ld in (a, b, p):
            ld.set_epoch(e)
        assert list(a) == list(b) == list(p)
    a.set_epoch(0)
    e0 = [x for batch in a for x in batch]
    a.set_epoch(1)
    assert [x for batch in a for x in batch] != e0
    for drop in (True, False):
        loaders = [GrainLoader(_Ints(23), 2, _collate, seed=9,
                               drop_last=drop, shard_index=s, num_shards=3)
                   for s in range(3)]
        jax = [JGrainLoader(_Ints(23), 2, _collate, seed=9, drop_last=drop,
                            shard_index=s, num_shards=3) for s in range(3)]
        for e in range(2):
            seen = []
            for ld, jl in zip(loaders, jax):
                ld.set_epoch(e)
                assert len(ld) == len(jl) == len(list(ld))
                seen += [x for batch in ld for x in batch]
            if not drop:
                assert sorted(seen) == list(range(23))
            assert len(seen) == len(set(seen))
        for k in (0, 1, len(loaders[1]) - 1, len(loaders[1])):
            assert list(loaders[1].iter_from(k)) == list(loaders[1])[k:]
    assert [x for batch in GrainLoader(_Ints(10), 3, _collate, shuffle=False,
                                       drop_last=False) for x in batch] == \
        list(range(10))


def test_grain_loader_iterator_resumes_from_its_state():
    ld = GrainLoader(_Ints(40), 4, _collate, seed=3)
    it = ld.iterator(num_epochs=2)
    consumed = [next(it) for _ in range(13)]
    state = it.get_state()
    rest = list(it)
    assert state == {"epoch": 1, "batch": 3}
    assert len(consumed) + len(rest) == 20  # 2 epochs x 10 batches
    it2 = GrainLoader(_Ints(40), 4, _collate, seed=3).iterator(num_epochs=2)
    it2.set_state(state)
    assert list(it2) == rest
    ld.set_epoch(1)
    assert consumed[10:] + rest == list(ld)
    e0 = [x for batch in consumed[:10] for x in batch]
    assert sorted(e0) == list(range(40))


def test_resume_position_takes_grain_loader_as_jax_does():
    from cvpce_tpu.train.loops import _resume_position as j_resume

    for meta in ({"epoch": 3, "epoch_step": 1}, {"epoch": 3, "epoch_step": 3},
                 {"epoch": 3}):
        assert loops._resume_position(
            meta, 4, GrainLoader(_Ints(8), 2, _collate)) == j_resume(
            meta, 4, JGrainLoader(_Ints(8), 2, _collate))
    assert loops._resume_position({"epoch": 3, "epoch_step": 1}, 4,
                                  GrainLoader(_Ints(8), 2, _collate)) == (3, 2)


# ------------------------------------------ the GLN loop resumed mid-epoch

H = W = 64


class _Scenes:
    """3 items shaped like SKU110KDataset's, a few small boxes and one
    large one each."""

    def __init__(self, n=3):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
            nb = int(rng.integers(2, 5))
            xy = rng.uniform(0, W - 20, (nb, 2)).astype(np.float32)
            wh = rng.uniform(8, 18, (nb, 2)).astype(np.float32)
            boxes = np.concatenate([np.concatenate([xy, xy + wh], -1),
                                    np.float32([[2, 3, 61, 60]])])
            self.items.append({
                "image": img, "boxes": boxes,
                "image_size": np.array([H, W], np.int32),
                "scale": np.float32(1.0), "orig_boxes": boxes})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _Interrupt(Exception):
    pass


class _InterruptedGrainLoader(GrainLoader):
    """Stops the run as it asks for epoch 1's third batch."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            if self.epoch == 1 and i == 2:
                raise _Interrupt
            yield batch


def _run(out, loader_cls, **kw):
    args = dict(batch_size=1, epochs=2, checkpoint_interval=2,
                eval_interval=5, eval_threshold=0.5, use_mesh=False, seed=3,
                device="cpu", loader_cls=loader_cls)
    args.update(kw)
    return loops.train_proposal_generator(
        _Scenes(), _Scenes(n=1), str(out),
        model_cfg=GLNConfig(canvas_h=H, canvas_w=W, max_nms_candidates=128,
                            detections_per_img=64),
        train_cfg=ptrain.GLNTrainConfig(match_chunk=1024, min_negatives=64),
        **args)


def _losses(out, epoch):
    with open(os.path.join(out, f"stats_{epoch}.json")) as f:
        stats = json.load(f)
    return [stats[k] for k in ("class_loss", "reg_loss", "gauss_loss")]


def test_gln_loop_resumes_mid_epoch_with_grain_loader(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = _run(tmp_path / "whole", GrainLoader)["state"]
        want = _losses(tmp_path / "whole", 1)
        shutil.rmtree(tmp_path / "whole")
        split = tmp_path / "split"
        with pytest.raises(_Interrupt):
            _run(split, _InterruptedGrainLoader)
        with open(split / "checkpoint.meta.json") as f:
            meta = json.load(f)
        assert (meta["epoch"], meta["iteration"], meta["epoch_step"]) == \
            (1, 4, 1)
        resumed = _run(split, GrainLoader, epochs=1, resume=True)["state"]
        assert resumed.step == whole.step == 6
        for key, v in whole.model.state_dict().items():
            assert torch.equal(resumed.model.state_dict()[key], v), key
        # the resumed run took one step, epoch 1's last: its stats
        assert [s[5:] for s in want] == _losses(split, 1)
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(tmp_path, ignore_errors=True)
