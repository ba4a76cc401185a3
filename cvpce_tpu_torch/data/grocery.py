"""Grocery Products datasets (the training hierarchy, the GP-180 test
set, the baseline CSV), the internal trainset and the simple folder
set; counterpart of cvpce_tpu/data/grocery.py.

The same directory walk, skip/only regexes, TrainingFiles.txt index,
annotation names, random crops for the generator (>= 0.8 scale, drawn
from `self.rng` in the JAX package's order) and white-background or
alpha masks. Images come from the port's PNG decoder (data/png.py);
GroceryProductsTestSet keeps the `.jpg` names of the dataset's layout,
and the decoder goes by the file's signature. Tensorised images are
f32 CPU tensors (transforms.aspect_resize_pad), the rest numpy.
"""
from __future__ import annotations

import csv
import os
import re
from os import path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import transforms as T

DEFAULT_SKIP = (r"^Background.*$", r"^.*/[Oo]riginals?$")
INDEX_JUNK = (".DS_Store", "index.txt", "TrainingClassesIndex.mat",
              "classes.csv", "Thumbs.db")


class GroceryProductsDataset:
    """Training-gallery dataset walking the GP category hierarchy.

    Items: (emb_img, gen_img, hierarchy[, annotation]): emb_img is the
    full product photo, gen_img an optional random crop (>= 0.8 scale)
    for the GAN generator; both aspect-resized and padded to 256 and
    tanh-scaled, (256, 256, 3) tensors, or (256, 256, 4) for gen_img
    with include_masks (the mask as the fourth channel).
    """

    def __init__(self, image_roots: Sequence[str],
                 skip: Sequence[str] = DEFAULT_SKIP,
                 only: Optional[Sequence[str]] = None,
                 random_crop: bool = True, min_cropped_size: float = 0.8,
                 resize: bool = True, include_annotations: bool = False,
                 include_masks: bool = False, index_from_file: bool = False,
                 seed: int = 0):
        self.skip_re = re.compile("|".join(f"({s})" for s in skip))
        if index_from_file:
            self.paths, self.categories, self.annotations = \
                self._index_from_file(image_roots, only)
        else:
            self.paths, self.categories, self.annotations = \
                self._index_walk(image_roots, only)
        self.random_crop = random_crop
        self.min_cropped_size = min_cropped_size
        self.resize = resize
        self.include_annotations = include_annotations
        self.include_masks = include_masks
        self.rng = np.random.default_rng(seed)

    def _index_walk(self, roots, only):
        ann_re = re.compile(r"^(.+)\.\w+$")
        paths, cats, anns = [], [], []
        for root in roots:
            stack = [(root, [])]
            while stack:
                cur, hier = stack.pop()
                if self.skip_re.match("/".join(hier)):
                    continue
                if only is not None and hier and hier[0] not in only:
                    continue
                for entry in os.scandir(cur):
                    if entry.is_dir(follow_symlinks=False):
                        stack.append((entry.path, hier + [entry.name]))
                    elif entry.is_file():
                        if entry.name in INDEX_JUNK:
                            continue
                        if self.skip_re.match("/".join(hier + [entry.name])):
                            continue
                        m = ann_re.match(entry.name)
                        if m is None:
                            print(f"Nonconforming filename: {entry.name}, "
                                  "skipping")
                            continue
                        paths.append(entry.path)
                        cats.append(hier)
                        anns.append("/".join([*hier, m.group(1)]))
        return paths, cats, anns

    def _index_from_file(self, roots, only,
                         index_filename: str = "TrainingFiles.txt"):
        paths, cats, anns = [], [], []
        for root in roots:
            with open(path.join(root, index_filename), "r") as f:
                for line in f:
                    parts = line.strip().split("/")
                    if len(parts) < 2:
                        continue
                    hier = parts[1:-1]
                    if only is not None and hier and hier[0] not in only:
                        continue
                    if self.skip_re.match("/".join(hier)):
                        continue
                    paths.append(path.join(root, *parts))
                    cats.append(hier)
                    anns.append("/".join(parts[1:]))
        return paths, cats, anns

    def index_for_ann(self, ann: str) -> Optional[int]:
        for i, a in enumerate(self.annotations):
            if a == ann:
                return i
        return None

    def _load(self, i: int) -> np.ndarray:
        return T.load_image(self.paths[i])

    def _mask(self, img: np.ndarray) -> np.ndarray:
        return T.build_white_background_mask(img)

    def _tensorize(self, img: np.ndarray, mask: bool = False):
        if not self.resize:
            return T.scale_to_tanh(T.as_tensor(img))
        if mask:
            return T.aspect_resize_pad(img, tanh=True, mask=self._mask(img))
        return T.aspect_resize_pad(img, tanh=True)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int):
        img = self._load(i)
        if self.random_crop:
            h, w = img.shape[:2]
            w_ratio = self.min_cropped_size + self.rng.random() \
                * (1 - self.min_cropped_size)
            min_h_ratio = self.min_cropped_size / w_ratio
            h_ratio = min_h_ratio + self.rng.random() * (1 - min_h_ratio)
            ch, cw = int(h * h_ratio), int(w * w_ratio)
            cy = self.rng.integers(0, h - ch) if ch < h else 0
            cx = self.rng.integers(0, w - cw) if cw < w else 0
            gen_img = img[cy:cy + ch, cx:cx + cw]
        else:
            gen_img = img

        emb = self._tensorize(img)
        if self.include_masks:
            gen = torch.cat(self._tensorize(gen_img, True),
                            dim=-1)  # (256, 256, 4)
        elif gen_img is img:  # no crop: the same tensorised image
            gen = emb.clone()
        else:
            gen = self._tensorize(gen_img)
        if self.include_annotations:
            return emb, gen, self.categories[i], self.annotations[i]
        return emb, gen, self.categories[i]


class InternalTrainSet(GroceryProductsDataset):
    """Private-dataset variant: RGBA images, the mask from alpha, white
    where alpha == 0, the front face preferred over the back."""

    DEFAULT_INTERNAL_SKIP = (r"^Unknown.*$",)

    def __init__(self, root: str, skip: Sequence[str] = DEFAULT_INTERNAL_SKIP,
                 **kwargs):
        super().__init__([root], skip=skip, **kwargs)
        ann_re = re.compile(r"^(.+/)*(\d+)")
        self.annotations = [ann_re.match(a).group(2) if ann_re.match(a) else a
                            for a in self.annotations]
        self._alpha_cache: Dict[int, np.ndarray] = {}

    def index_for_ann(self, ann: str) -> Optional[int]:
        candidate = None
        for i, a in enumerate(self.annotations):
            if a == ann:
                if "front" in self.categories[i]:
                    return i
                if "back" in self.categories[i] or candidate is None:
                    candidate = i
        return candidate

    def _load(self, i: int) -> np.ndarray:
        rgba = T.load_image_rgba(self.paths[i])
        rgb = rgba[..., :3].copy()
        alpha0 = rgba[..., 3] == 0
        rgb[alpha0] = 1.0  # white where transparent
        self._alpha_cache[i] = alpha0
        return rgb

    def _mask(self, img: np.ndarray) -> np.ndarray:
        for idx, alpha0 in self._alpha_cache.items():
            if alpha0.shape == img.shape[:2]:
                return alpha0
        return T.build_white_background_mask(img)


class SimpleFolderSet:
    """One image per class, the file name is the label. Items (img,
    img, cls, cls): with `train` a (256, 256, 3) tensor
    (resize_for_classification), else the decoded numpy image."""

    def __init__(self, root: str, train: bool = True,
                 types: Tuple[str, ...] = (".png", ".jpg", ".jpeg")):
        self.train = train
        self.paths: List[str] = []
        self.classes: List[str] = []
        type_re = "|".join("\\" + t for t in types)
        name_re = re.compile(f"^(.*)({type_re})$")
        for f in sorted(os.scandir(root), key=lambda e: e.name):
            m = name_re.match(f.name)
            if m is None:
                continue
            self.paths.append(f.path)
            self.classes.append(m.group(1))

    def index_for_ann(self, ann: str) -> int:
        return self.classes.index(ann)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int):
        img = T.load_image(self.paths[i])
        if self.train:
            img = T.resize_for_classification(img)
        c = self.classes[i]
        return img, img, c, c


class GroceryProductsTestSet:
    """GP-180 test set: per-store annotation CSVs s{store}_{img}.csv.
    Items (img numpy, anns, boxes)."""

    def __init__(self, image_dir: str, ann_dir: str,
                 only=None, skip=None):
        self.image_dir = image_dir
        self.toskip = skip if isinstance(skip, int) else 0
        self.tokeep = only if isinstance(only, int) else 9999
        self.index = self._build_index(
            ann_dir,
            only=None if isinstance(only, int) else only,
            skip=None if isinstance(skip, int) else skip,
        )
        anns = sorted({a for e in self.index for a in e["anns"]})
        self.int_to_ann = anns
        self.ann_to_int = {a: i for i, a in enumerate(anns)}

    def get_image_path(self, store: str, image: str) -> str:
        return path.join(self.image_dir, f"store{store}", "images",
                         f"store{store}_{image}.jpg")

    def _build_index(self, ann_dir, only, skip) -> List[Dict]:
        ann_file_re = re.compile(r"^s(\d+)_(\d+)\.csv$")
        ann_re = re.compile(r"^(.+)\.jpg")
        index = []
        for entry in sorted(os.scandir(ann_dir), key=lambda e: e.name):
            if not entry.is_file():
                continue
            if only is not None and entry.name not in only:
                continue
            if skip is not None and entry.name in skip:
                continue
            m = ann_file_re.match(entry.name)
            if m is None:
                continue
            anns, boxes = [], []
            with open(entry.path, "r") as f:
                for row in csv.reader(f, skipinitialspace=True):
                    if len(row) != 5:
                        print(f"Malformed annotation row in {entry.name}: "
                              f"{row}; skipping")
                        continue
                    ann, x1, y1, x2, y2 = row
                    am = ann_re.match(ann)
                    if am is None:
                        print(f"Non-conforming annotation in {entry.name}: "
                              f"{ann}; skipping")
                        continue
                    anns.append(am.group(1))
                    boxes.append([int(c) for c in (x1, y1, x2, y2)])
            index.append({
                "id": (m.group(1), m.group(2)),
                "path": self.get_image_path(m.group(1), m.group(2)),
                "anns": anns,
                "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            })
        return index

    def get_index_for(self, store, image) -> Optional[int]:
        target = self.get_image_path(store, image)
        for i, e in enumerate(self.index):
            if e["path"] == target:
                return i
        return None

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int):
        e = self.index[i]
        img = T.load_image(e["path"])
        sl = slice(self.toskip, self.tokeep)
        return img, e["anns"][sl], e["boxes"][sl]


class GPBaselineDataset:
    """Tonioni baseline flat-CSV annotations. Items (img numpy, boxes)."""

    def __init__(self, img_dir: str, annotation_file: str):
        self.index = self._build_index(img_dir, annotation_file)

    @staticmethod
    def _build_index(img_dir, annotation_file) -> List[Dict]:
        index: Dict[str, Dict] = {}
        image_re = re.compile(r"^(store\d)\_\d+.jpg$")
        with open(annotation_file, "r") as f:
            for i, row in enumerate(csv.reader(f)):
                if i == 0:
                    continue
                if len(row) != 6:
                    print(f"Malformed annotation row: {row}, skipping")
                    continue
                name, x1, y1, x2, y2, _ = row
                if name not in index:
                    m = image_re.match(name)
                    if m is None:
                        print(f"Malformed annotation row: {row}, skipping")
                        continue
                    index[name] = {
                        "image_path": path.join(img_dir, m.group(1),
                                                "images", name),
                        "boxes": [],
                    }
                index[name]["boxes"].append(
                    [int(c) for c in (x1, y1, x2, y2)])
        out = []
        for e in index.values():
            e["boxes"] = np.asarray(e["boxes"], np.float32)
            out.append(e)
        return out

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int):
        e = self.index[i]
        return T.load_image(e["image_path"]), e["boxes"]
