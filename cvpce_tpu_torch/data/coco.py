"""Minimal COCO detection dataset (a pure-JSON reader); counterpart of
cvpce_tpu/data/coco.py: the image index, xywh -> xyxy boxes and the
category names. Images come from the port's PNG and JPEG decoders
(transforms.decode_image).
"""
from __future__ import annotations

import json
from os import path
from typing import Dict, List

import numpy as np

from . import transforms as T


class CocoDetectionDataset:
    def __init__(self, img_dir: str, annotation_file: str):
        self.img_dir = img_dir
        with open(annotation_file, "r") as f:
            coco = json.load(f)
        self.categories = {c["id"]: c["name"]
                           for c in coco.get("categories", [])}
        images = {im["id"]: im for im in coco["images"]}
        index: Dict[int, Dict] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd"):
                continue
            img = images.get(ann["image_id"])
            if img is None:
                continue
            entry = index.setdefault(ann["image_id"], {
                "file_name": img["file_name"],
                "width": img["width"],
                "height": img["height"],
                "boxes": [],
                "labels": [],
            })
            x, y, w, h = ann["bbox"]
            entry["boxes"].append([x, y, x + w, y + h])
            entry["labels"].append(ann["category_id"])
        self.index: List[Dict] = []
        for img_id in sorted(index):
            e = index[img_id]
            e["image_id"] = img_id
            e["boxes"] = np.asarray(e["boxes"], np.float32)
            e["labels"] = np.asarray(e["labels"], np.int64)
            self.index.append(e)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        e = self.index[i]
        img = T.load_image(path.join(self.img_dir, e["file_name"]))
        return img, e
