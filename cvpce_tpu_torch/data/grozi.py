"""GroZi-120 datasets: the inVitro web-image train set and the
video-frame test set; counterpart of cvpce_tpu/data/grozi.py. Images
come from the port's PNG and JPEG decoders (transforms.decode_image);
the test frames come out of the videos through the port's AVI reader
and JPEG writer."""
from __future__ import annotations

import csv
import os
from os import path
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import avi, jpeg
from . import transforms as T


def iter_grozi_annotations(base_dir: str, products: int = 120) -> Iterator:
    ann_dir = path.join(base_dir, "inSitu")
    for p in range(1, products + 1):
        coord_path = path.join(ann_dir, str(p), "coordinates.txt")
        with open(coord_path, "r") as f:
            for row in csv.reader(f, delimiter="\t"):
                yield [p] + [int(v) for v in row]


def extracted_img_name(video: int, frame: int) -> str:
    return f"{video}_{frame}.jpg"


def extract_grozi_test_imgs(base_dir: str, products: int = 120) -> None:
    """Pulls the annotated frames out of GroZi-120's Shelf_*.avi videos
    (cvpce/datautils.py:528-565), as the JAX package does with cv2: each
    video's frames of interest (from `inSitu/*/coordinates.txt`) are
    written as `extracted/{v}_{f}.jpg`, in the order the videos are
    first named there and then frame by frame, and listed in that order
    in `extracted/index.txt`; frames past a video's end are reported.
    The videos are read by `data/avi.py` (Motion-JPEG, decoded as cv2's
    libjpeg backend decodes) and written by `jpeg.save_jpeg` (the bytes
    cv2.imwrite writes). A missing video has no frames, as a
    cv2.VideoCapture of a missing file reads none."""
    frames_of_interest: Dict[int, set] = {}
    for _, video, frame, *_ in iter_grozi_annotations(base_dir, products):
        frames_of_interest.setdefault(video, set()).add(frame)

    video_dir = path.join(base_dir, "video")
    out_dir = path.join(base_dir, "extracted")
    os.makedirs(out_dir, exist_ok=True)
    index = []
    for v, frames in frames_of_interest.items():
        video_path = path.join(video_dir, f"Shelf_{v}.avi")
        video = avi.open_avi(video_path) if path.exists(video_path) \
            else None
        for f in sorted(frames) if video is not None else ():
            if f >= len(video):
                break
            filename = extracted_img_name(v, f)
            jpeg.save_jpeg(path.join(out_dir, filename), video.frame(f))
            index.append(filename + "\n")
            frames.remove(f)
        if frames:
            print(f"Not all frames extracted from video {v}: "
                  f"missing {sorted(frames)[:10]}...")
    with open(path.join(out_dir, "index.txt"), "w") as f:
        f.writelines(index)


class GroZiDataset:
    """inVitro per-product web images (`.jpg` names). Items (img numpy,
    product number)."""

    def __init__(self, base_dir: str, products: int = 120):
        self.index: List[Dict] = []
        vitro = path.join(base_dir, "inVitro")
        for p in range(1, products + 1):
            img_dir = path.join(vitro, str(p), "web", "JPEG")
            for entry in sorted(os.scandir(img_dir), key=lambda e: e.name):
                if entry.is_file() and entry.name.endswith(".jpg"):
                    self.index.append({"path": entry.path, "ann": p})

    def index_for_ann(self, ann: int) -> Optional[int]:
        for i, e in enumerate(self.index):
            if e["ann"] == ann:
                return i
        return None

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int):
        e = self.index[i]
        return T.load_image(e["path"]), e["ann"]


class GroZiTestSet:
    """Extracted annotated video frames. Items (img numpy, anns,
    boxes)."""

    def __init__(self, base_dir: str):
        index: Dict[str, Dict] = {}
        img_dir = path.join(base_dir, "extracted")
        with open(path.join(img_dir, "index.txt"), "r") as f:
            for line in f:
                name = line.strip()
                index[name] = {"path": path.join(img_dir, name),
                               "anns": [], "boxes": []}
        for ann, video, frame, x, y, w, h in iter_grozi_annotations(base_dir):
            key = extracted_img_name(video, frame)
            if key not in index:
                continue
            index[key]["anns"].append(ann)
            index[key]["boxes"].append([x, y, x + w, y + h])
        self.index = [
            {"path": v["path"],
             "anns": np.asarray(v["anns"], np.int64),
             "boxes": np.asarray(v["boxes"], np.float32).reshape(-1, 4)}
            for v in index.values()
        ]

    def most_annotated(self) -> List[int]:
        counts = [len(e["anns"]) for e in self.index]
        m = max(counts, default=0)
        return [i for i, c in enumerate(counts) if c == m]

    def least_annotated(self) -> List[int]:
        counts = [len(e["anns"]) for e in self.index]
        m = min(counts, default=0)
        return [i for i, c in enumerate(counts) if c == m]

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int):
        e = self.index[i]
        return T.load_image(e["path"]), e["anns"], e["boxes"]
