"""DIHE classification evaluation: gallery-kNN top-k accuracy over the
ground-truth boxes of a test set; counterpart of
cvpce_tpu/eval/classification.py. The crops are the port's f32 gather
(ops/image.py:crop_resize_square) on the device, where the JAX package
uses its bf16 einsum resampler."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..data import transforms as T
from ..ops.image import crop_resize_square, scale_to_tanh
from ..pipeline.classifier import Classifier
from ..utils import resolve_device


def eval_dihe(encoder_fn, embedding_size: int, sampleset, testset,
              batch_size: int = 32, k: Sequence[int] = (1,),
              load_index: str | None = None,
              verbose: bool = True, index_average: int = 1,
              mesh=None, device="cuda") -> Dict[int, float]:
    """Top-k accuracy per k. `mesh`: the gallery is held row-sharded
    over its ranks (pipeline/classifier.py), every rank scoring every
    query and returning the same accuracies."""
    dev = resolve_device(device)
    if verbose:
        print("Preparing classifier...")
    classifier = Classifier(encoder_fn, embedding_size, sampleset,
                            batch_size=batch_size, k=max(k),
                            load=load_index, index_average=index_average,
                            mesh=mesh, device=dev)

    total = 0
    correct = {knn: 0 for knn in k}
    missed: Dict = {}
    confusion: Dict = {}
    total_per_ann: Dict = {}

    if verbose:
        print("Eval start!")
    for i in range(len(testset)):
        img, target_anns, boxes = testset[i]
        if verbose and i % 10 == 0:
            print(f"{i}...")
        h, w = img.shape[:2]
        boxes = np.asarray(boxes, np.float32)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        with torch.inference_mode():
            crops = scale_to_tanh(crop_resize_square(
                T.as_tensor(img, dev), torch.from_numpy(boxes).to(dev)))
        pred_anns = classifier.classify(crops)

        total += len(target_anns)
        for a1, a2 in zip(target_anns, pred_anns):
            total_per_ann[a1] = total_per_ann.get(a1, 0) + 1
            for knn in k:
                if a1 in a2[:knn]:
                    correct[knn] += 1
            if a1 != a2[0]:
                missed[a1] = missed.get(a1, 0) + 1
                confusion.setdefault(a1, {})
                confusion[a1][a2[0]] = confusion[a1].get(a2[0], 0) + 1

    accuracy = {knn: c / total for knn, c in correct.items()} if total else {}
    if verbose and total:
        print(f"Total annotations: {total}, Correct: {correct}, "
              f"Accuracy: {accuracy}")
        most_missed = sorted(
            ((v / total_per_ann[a], v, a) for a, v in missed.items()),
            reverse=True)[:10]
        print("Most missed: " + ", ".join(
            f"{a} ({n}, {p * 100:.1f}%)" for p, n, a in most_missed))
        for _, n, a in most_missed[:3]:
            common = sorted(((v / n, v, b) for b, v in confusion[a].items()),
                            reverse=True)[:3]
            print(f"{a}: commonly mistaken for " + ", ".join(
                f"{b} ({m}, {p * 100:.1f}%)" for p, m, b in common))
    return accuracy
