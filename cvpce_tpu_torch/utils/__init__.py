"""Host-side utilities: device resolution, label/tensor mapping."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. `cuda` is the default and is
    never silently replaced by the CPU: without a card it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def labels_to_tensors(*label_lists: Sequence) -> Tuple:
    """N lists of hashable labels -> int arrays plus a shared key
    (cvpce_tpu/utils/__init__.py:labels_to_tensors). Returns
    (*arrays, key)."""
    key: List = []
    lookup = {}
    arrays = []
    for labels in label_lists:
        ids = []
        for lbl in labels:
            if lbl not in lookup:
                lookup[lbl] = len(key)
                key.append(lbl)
            ids.append(lookup[lbl])
        arrays.append(np.asarray(ids, dtype=np.int64))
    return (*arrays, key)


def tensors_to_labels(key: Sequence, *arrays) -> List[List]:
    """Inverse of labels_to_tensors."""
    return [[key[int(i)] for i in arr] for arr in arrays]
