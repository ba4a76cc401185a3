"""Record-cache dataset wrapper over the native reader; counterpart of
cvpce_tpu/data/cache.py.

The first pass decodes and transforms each item once and appends its
fixed-shape arrays to a flat binary file; afterwards batches come from
`csrc/record_cache.cpp` (a byte copy of the JAX package's
`native/record_cache.cpp`: mmap, a small thread pool copying records),
with no image decode and no per-item Python. The file is byte for byte
the one the JAX package writes from the same items. `_build.load`
compiles the reader with g++ into `build/cvpce_tpu_torch/` at first
use; where it does not build, building or opening a cache raises (no
Python fallback).
"""
from __future__ import annotations

import ctypes
from os import path
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from .sku110k import pad_boxes

_HEADER_BYTES = 24


def _lib() -> ctypes.CDLL:
    lib = _build.load("record_cache")
    lib.rc_open.restype = ctypes.c_void_p
    lib.rc_open.argtypes = [ctypes.c_char_p]
    lib.rc_num_records.restype = ctypes.c_int64
    lib.rc_num_records.argtypes = [ctypes.c_void_p]
    lib.rc_record_bytes.restype = ctypes.c_int64
    lib.rc_record_bytes.argtypes = [ctypes.c_void_p]
    lib.rc_read_batch.restype = ctypes.c_int32
    lib.rc_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ]
    lib.rc_close.restype = None
    lib.rc_close.argtypes = [ctypes.c_void_p]
    lib.rc_write_header.restype = ctypes.c_int32
    lib.rc_write_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64]
    return lib


def native_available() -> bool:
    """Whether the reader builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


class RecordCache:
    """Fixed-shape record store. Records are dicts of arrays with a
    static spec {name: (shape, dtype)} packed back to back."""

    def __init__(self, cache_path: str, spec: Dict[str, Tuple]):
        self.path = cache_path
        self.spec = {k: (tuple(s), np.dtype(d)) for k, (s, d) in spec.items()}
        self._offsets = {}
        off = 0
        for k, (shape, dt) in self.spec.items():
            nbytes = int(np.prod(shape)) * dt.itemsize
            self._offsets[k] = (off, nbytes)
            off += nbytes
        self.record_bytes = off
        self._handle = None
        self._n = 0

    # -- writing -----------------------------------------------------
    def build(self, dataset, extract: Callable[[int], Dict[str, np.ndarray]],
              verbose: bool = True) -> None:
        """Write `extract(i)` for every item of `dataset`; each value may
        be a numpy array or a tensor."""
        n = len(dataset)
        lib = _lib()
        with open(self.path, "wb") as f:
            f.write(b"\0" * _HEADER_BYTES)
            for i in range(n):
                rec = extract(i)
                for k, (shape, dt) in self.spec.items():
                    arr = np.ascontiguousarray(_host(rec[k]), dtype=dt)
                    if arr.shape != shape:
                        raise ValueError(f"record {i} field {k}: shape "
                                         f"{arr.shape}, spec {shape}")
                    f.write(arr.tobytes())
                if verbose and i % 200 == 0:
                    print(f"cache {i}/{n}")
        if lib.rc_write_header(self.path.encode(), self.record_bytes, n):
            raise OSError(f"cannot write the header of {self.path}")

    # -- reading -----------------------------------------------------
    def open(self) -> None:
        lib = _lib()
        self._handle = lib.rc_open(self.path.encode())
        if not self._handle:
            raise OSError(f"cannot open cache {self.path}")
        self._n = int(lib.rc_num_records(self._handle))
        if int(lib.rc_record_bytes(self._handle)) != self.record_bytes:
            self.close()
            raise ValueError(f"{self.path}: records of another spec")

    def __len__(self) -> int:
        return self._n

    def read_batch(self, indices: Sequence[int],
                   threads: int = 8) -> Dict[str, np.ndarray]:
        if not self._handle:
            raise RuntimeError(f"cache {self.path} is not open")
        idx = np.ascontiguousarray(indices, np.int64)
        out = np.empty(len(idx) * self.record_bytes, np.uint8)
        rc = _lib().rc_read_batch(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            threads)
        if rc:
            raise IndexError(f"rc_read_batch failed ({rc}): indices "
                             f"outside [0, {self._n})")
        batch = {}
        recs = out.reshape(len(idx), self.record_bytes)
        for k, (shape, dt) in self.spec.items():
            off, nbytes = self._offsets[k]
            flat = recs[:, off:off + nbytes].copy()
            batch[k] = flat.view(dt).reshape((len(idx), *shape))
        return batch

    def close(self) -> None:
        if self._handle:
            _lib().rc_close(self._handle)
            self._handle = None


class CachedDetectionDataset:
    """SKU110K-style detection dataset served from a record cache.

    Built once from any dataset yielding canvas items (data/sku110k.py
    item dicts, tensor or numpy images); then __getitem__ is a pure
    cache read, in numpy. Caching freezes the hflip draw: cache the
    unflipped canvas and flip on the device for training if the exact
    reference augmentation is needed.
    """

    def __init__(self, base, cache_path: str, box_bucket: int = 768,
                 rebuild: bool = False, verbose: bool = True):
        item = base[0]
        h, w, c = item["image"].shape
        self.box_bucket = box_bucket
        spec = {
            "image": ((h, w, c), np.float32),
            "boxes": ((box_bucket, 4), np.float32),
            "box_valid": ((box_bucket,), np.bool_),
            "image_size": ((2,), np.int32),
            "scale": ((1,), np.float32),
        }
        self.cache = RecordCache(cache_path, spec)
        if rebuild or not path.exists(cache_path):
            def extract(i):
                it = base[i]
                boxes, valid = pad_boxes(it["boxes"], box_bucket)
                return {
                    "image": it["image"],
                    "boxes": boxes[:box_bucket],
                    "box_valid": valid[:box_bucket],
                    "image_size": it["image_size"],
                    "scale": np.full((1,), it["scale"], np.float32),
                }

            self.cache.build(base, extract, verbose=verbose)
        self.cache.open()

    def __len__(self):
        return len(self.cache)

    def read_batch(self, indices, threads: int = 8) -> Dict[str, np.ndarray]:
        b = self.cache.read_batch(indices, threads=threads)
        return {
            "images": b["image"],
            "boxes": b["boxes"],
            "box_valid": b["box_valid"],
            "image_sizes": b["image_size"],
        }

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        b = self.read_batch([i])
        return {k: v[0] for k, v in b.items()}
