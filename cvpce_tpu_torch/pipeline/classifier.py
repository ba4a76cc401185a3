"""Gallery classifier: embed a product gallery once, classify crops by
cosine kNN (torch); counterpart of cvpce_tpu/pipeline/classifier.py.

The gallery stays resident on the device. Galleries of >= 4096 entries
with k <= 8 search through the fused CUDA kernel
(ops/knn.py:nearest_neighbors_fused), smaller ones through the plain
distance matrix, as in the JAX package. The saved index is the same
`np.savez` file (`embedding`, `annotations` and, for an int8
static-scale encoder, `act_scales`: a one-element object array holding
the plain float tree `{'f2': {'scale': s}, ...}`), so an index saved by
either package loads in the other and restores the encoder's scales.
"""
from __future__ import annotations

import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops.knn import (inverse_norms, nearest_neighbors,
                       nearest_neighbors_fused)
from ..utils import resolve_device

FUSED_MIN_GALLERY = 4096
FUSED_MAX_K = 8


class Classifier:
    def __init__(self, encoder_fn: Callable, embedding_size: int,
                 sample_set=None, batch_size: int = 32, k: int = 1,
                 load: Optional[str] = None, index_average: int = 1,
                 device="cuda"):
        """encoder_fn: (B, 256, 256, 3) tanh-scale -> (B, D) embeddings.
        sample_set: items (emb_img, gen_img, hierarchy, annotation) or
        (img, img, cls, cls). index_average > 1 collapses each run of
        that many consecutive sample_set items (which must share an
        annotation) into one index entry holding their mean embedding;
        it applies when the index is built, not when it is loaded."""
        self.device = resolve_device(device)
        self.encoder_fn = encoder_fn
        self.embedding_size = embedding_size
        self.batch_size = batch_size
        self.k = k
        self.index_average = index_average
        if load is not None:
            if index_average > 1:
                warnings.warn(
                    "index_average>1 is ignored when loading a saved "
                    "index; it only applies in build_index", stacklevel=2)
            self.embedding, self.annotations, scales = self._load_index(
                load)
            if scales is not None and hasattr(encoder_fn, "set_scales"):
                # queries embed in the numerics the gallery was built in
                encoder_fn.set_scales(scales)
        elif sample_set is None:
            raise ValueError("pass a sample_set to index, or load=")
        else:
            self.embedding, self.annotations = self.build_index(sample_set)
        self._anchors_dev = torch.from_numpy(
            np.asarray(self.embedding, np.float32)).to(self.device)
        self._use_fused = (len(self.embedding) >= FUSED_MIN_GALLERY
                           and k <= FUSED_MAX_K)
        # the resident gallery's norms, taken once for every search
        self._anchor_inv_norms = (inverse_norms(self._anchors_dev)
                                  if self._use_fused else None)

    def _embed(self, imgs) -> torch.Tensor:
        return self.encoder_fn(imgs).to(self.device, torch.float32)

    def _batch(self, sample_set, start: int, n: int) -> List:
        return [sample_set[i]
                for i in range(start, min(start + self.batch_size, n))]

    def build_index(self, sample_set):
        embeddings: List[np.ndarray] = []
        annotations: List = []
        n = len(sample_set)
        if getattr(self.encoder_fn, "needs_calibration", False) and n:
            # an int8 static-scale encoder calibrates on the first four
            # batches of the gallery itself; the scales persist with the
            # index (save_index)
            self.encoder_fn.calibrate([
                torch.stack([torch.as_tensor(it[0])
                             for it in self._batch(sample_set, start, n)])
                for start in range(0, min(n, 4 * self.batch_size),
                                   self.batch_size)])
        for start in range(0, n, self.batch_size):
            items = self._batch(sample_set, start, n)
            imgs = torch.stack([torch.as_tensor(it[0]) for it in items])
            embeddings.append(self._embed(imgs).cpu().numpy())
            annotations += [it[3] if len(it) > 3 else it[2] for it in items]
        embedding = (np.concatenate(embeddings) if embeddings else
                     np.zeros((0, self.embedding_size), np.float32))
        f = self.index_average
        if f > 1 and len(embedding):
            assert len(embedding) % f == 0, \
                f"index_average={f} must divide gallery size {len(embedding)}"
            groups = [annotations[i * f:(i + 1) * f]
                      for i in range(len(annotations) // f)]
            assert all(len(set(map(str, g))) == 1 for g in groups), \
                "index_average groups must share one annotation"
            embedding = embedding.reshape(-1, f,
                                          embedding.shape[-1]).mean(1)
            annotations = annotations[::f]
        return embedding, annotations

    def save_index(self, path: str) -> None:
        extra = {}
        scales = getattr(self.encoder_fn, "get_scales", lambda: None)()
        if scales is not None:
            extra["act_scales"] = np.array([scales], dtype=object)
        np.savez(path, embedding=self.embedding,
                 annotations=np.array(self.annotations, dtype=object),
                 **extra)

    @staticmethod
    def load_index(path: str):
        emb, anns, _ = Classifier._load_index(path)
        return emb, anns

    @staticmethod
    def _load_index(path: str):
        data = np.load(path, allow_pickle=True)
        scales = (data["act_scales"][0] if "act_scales" in data.files
                  else None)
        return data["embedding"], list(data["annotations"]), scales

    def search(self, emb: torch.Tensor) -> torch.Tensor:
        """(Q, k) gallery indices for (Q, D) embeddings on the device."""
        if self._use_fused:
            return nearest_neighbors_fused(
                self._anchors_dev, emb, self.k, self._anchor_inv_norms)[1]
        return nearest_neighbors(self._anchors_dev, emb, self.k)

    @torch.inference_mode()
    def classify(self, images, return_embedding: bool = False):
        """images: (N, 256, 256, 3) in tanh scale, numpy or tensor.
        Returns the k nearest annotations per image."""
        results: List[List] = []
        embs: List[torch.Tensor] = []
        for start in range(0, len(images), self.batch_size):
            emb = self._embed(images[start:start + self.batch_size])
            embs.append(emb)
            nearest = self.search(emb).cpu().numpy()
            results += [[self.annotations[j] for j in row]
                        for row in nearest]
        if return_embedding:
            return results, (torch.cat(embs).cpu().numpy() if embs else
                             np.zeros((0, self.embedding_size), np.float32))
        return results
