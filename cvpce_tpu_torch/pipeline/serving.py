"""Inference-only serving exports of the port's training runs, and the
loaders that read either layout; counterpart of
cvpce_tpu/pipeline/serving.py.

The training loops checkpoint the whole train state
(train/checkpoint.py: one `torch.save` file of a state's `state_dict()`:
for GLN the model, the SGD momentum buffers and the step; for DIHE the
three players, their Adam states and the step). Serving needs only the
model. An export is a directory in the JAX package's layout, which its
serving loaders read:

- `serving_checkpoint`: an orbax checkpoint (OCDBT, zarr v2, zstd),
  written by the port's own writer (utils/orbax_write.py) with the trees
  of cvpce_tpu/pipeline/serving.py: `{params, frozen, batch_stats}` for
  a GLN, `{params, batch_stats}` for a DIHE encoder, with flax's names
  (utils/weights.py: `gln_variables`, `macvgg_variables`);
- `serving_calibration.json` and `serving_checkpoint.meta.json`, copied
  byte for byte from the run, so that the calibrated threshold, the
  input preprocessing and the epoch travel with the weights
  (pipeline/calibrate.py).

The loaders take an export or a training-run directory (`checkpoint`,
`embedder_checkpoint`, or a named node such as `epoch_3`) and return the
model's state_dict, on the CPU. They read the JAX package's orbax
directories as well, wherever the JAX loaders read them: a serving
export whose `serving_checkpoint` is an orbax directory (artifacts/),
or a JAX run's `checkpoint`, `epoch_N` or `embedder_checkpoint` node.
Those go through the port's own orbax reader (utils/orbax_read.py) and
the bridges of utils/weights.py (`gln_state_dict`, `macvgg_state_dict`).
The loaders also read the exports that earlier versions of the port
wrote: a `serving_checkpoint` file of `torch.save`, `{"model":
state_dict}` for a GLN or `{"embedder": state_dict}` for a DIHE encoder.
The exports read any of these and write the JAX package's layout.
"""
from __future__ import annotations

import json
import os
import shutil
from os import path
from typing import Dict, Optional

import torch

from ..utils import orbax_read, orbax_write
from ..utils.weights import (gln_state_dict, gln_variables,
                             macvgg_state_dict, macvgg_variables)
from .calibrate import CALIBRATION_FILE

SERVING_NAME = "serving_checkpoint"
# the part of a port training checkpoint that serving keeps: the GLN
# loop's GLNTrainState (train/gln.py) its `model`, train_dihe's
# DIHETrainState (train/dihe.py) its `embedder`
GLN_PART = "model"
DIHE_PART = "embedder"


def _read(target: str, what: str) -> Dict:
    """The dict that `torch.save` wrote at `target`."""
    if path.isdir(target):
        raise ValueError(
            f"{target} is not a {what} checkpoint: a directory without "
            f"{orbax_read.METADATA}, which the JAX package's orbax nodes "
            "hold")
    if not path.exists(target):
        raise ValueError(
            f"no checkpoint file {target}: the directory is neither a "
            "training run nor a serving export, of the port (torch.save "
            "files) or of the JAX package (orbax directories)")
    obj = torch.load(target, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{target} holds a {type(obj).__name__}, not a "
                         "checkpoint dict")
    return obj


def _gln_node(target: str, ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The GLN state_dict of one checkpoint node: a JAX orbax directory
    ({params, frozen, batch_stats}, cvpce_tpu/pipeline/serving.py
    `load_gln_variables`) or a port file (its `model`)."""
    if orbax_read.is_checkpoint(target):
        state = orbax_read.restore(target)
        missing = [k for k in ("params", "frozen", "batch_stats")
                   if k not in state]
        if missing:
            raise ValueError(
                f"{ckpt_dir} is not a GLN checkpoint: missing {missing}")
        return gln_state_dict(state)
    state = _read(target, "GLN")
    if GLN_PART not in state:
        raise ValueError(f"{ckpt_dir} is not a GLN checkpoint: missing "
                         f"['{GLN_PART}'] (keys: {sorted(map(str, state))})")
    return state[GLN_PART]


def _dihe_node(target: str, ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The MACVGG state_dict of one checkpoint node: a JAX orbax
    directory (a serving export's params / batch_stats, or a DIHE train
    state's emb_params / emb_stats) or a port file (its `embedder`). A
    GLN tree is refused, as the JAX loader refuses a tree with a
    'frozen' collection: loading foreign weights into the embedder would
    serve garbage."""
    if orbax_read.is_checkpoint(target):
        state = orbax_read.restore(target)
        if "frozen" in state:
            raise ValueError(
                f"{ckpt_dir} looks like a GLN checkpoint (has a 'frozen' "
                "collection), not a DIHE encoder")
        if "params" in state:
            return macvgg_state_dict(state["params"], state["batch_stats"])
        if "emb_params" in state:
            return macvgg_state_dict(state["emb_params"], state["emb_stats"])
        raise ValueError(f"{ckpt_dir} is not a DIHE checkpoint "
                         f"(keys: {sorted(state)})")
    state = _read(target, "DIHE")
    if GLN_PART in state:
        raise ValueError(
            f"{ckpt_dir} looks like a GLN checkpoint (has a '{GLN_PART}' "
            "entry), not a DIHE encoder")
    if DIHE_PART in state:
        return state[DIHE_PART]
    raise ValueError(f"{ckpt_dir} is not a DIHE checkpoint "
                     f"(keys: {sorted(map(str, state))})")


def _serving_tree(state_dict: Dict[str, torch.Tensor], part: str) -> Dict:
    """The tree that the JAX package's `export_*_serving` saves."""
    if part == GLN_PART:
        return gln_variables(state_dict)
    params, batch_stats = macvgg_variables(state_dict)
    return {"params": params, "batch_stats": batch_stats}


def _copy_sidecars(run_dir: str, out_dir: str, meta_src: str) -> None:
    cal = path.join(run_dir, CALIBRATION_FILE)
    if path.exists(cal):
        shutil.copyfile(cal, path.join(out_dir, CALIBRATION_FILE))
    meta = path.join(run_dir, meta_src + ".meta.json")
    if path.exists(meta):
        shutil.copyfile(meta,
                        path.join(out_dir, SERVING_NAME + ".meta.json"))


def _export(run_dir: str, out_dir: str, name: str, part: str) -> str:
    node = _gln_node if part == GLN_PART else _dihe_node
    state_dict = node(path.join(run_dir, name), path.join(run_dir, name))
    os.makedirs(out_dir, exist_ok=True)
    orbax_write.save(path.join(out_dir, SERVING_NAME),
                     _serving_tree(state_dict, part))
    _copy_sidecars(run_dir, out_dir, name)
    return out_dir


def export_gln_serving(run_dir: str, out_dir: str,
                       name: str = "checkpoint") -> str:
    """Export a GLN training run's model, as the JAX package's
    {params, frozen, batch_stats}, with its calibration and meta
    sidecars to `out_dir`; the SGD buffers and the step stay behind."""
    return _export(run_dir, out_dir, name, GLN_PART)


def export_dihe_serving(run_dir: str, out_dir: str,
                        name: str = "embedder_checkpoint") -> str:
    """Export a DIHE run's encoder, as the JAX package's {params,
    batch_stats}, to `out_dir`. The GAN players and every optimizer
    state stay behind: eval needs only the embedder
    (cvpce/cli/dihe.py:301-309)."""
    return _export(run_dir, out_dir, name, DIHE_PART)


def _serving_path(ckpt_dir: str) -> Optional[str]:
    p = path.join(ckpt_dir, SERVING_NAME)
    return p if path.exists(p) else None


def load_gln_variables(ckpt_dir: str,
                       name: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """The GLN state_dict of a serving export or of a training-run
    directory's checkpoint `name`, of the port or of the JAX package.

    The serving-export shortcut applies only for the default name: a
    caller that asked for a specific node (e.g. epoch_87) gets that node,
    not a serving export that sits in the same directory."""
    serving = _serving_path(ckpt_dir) if name == "checkpoint" else None
    return _gln_node(serving or path.join(ckpt_dir, name), ckpt_dir)


def load_dihe_encoder(ckpt_dir: str, name: str = "embedder_checkpoint"
                      ) -> Dict[str, torch.Tensor]:
    """The MACVGG encoder state_dict of a DIHE serving export or of a
    training-run directory's checkpoint `name`, of the port or of the JAX
    package. A GLN export or run is refused."""
    serving = (_serving_path(ckpt_dir)
               if name == "embedder_checkpoint" else None)
    return _dihe_node(serving or path.join(ckpt_dir, name), ckpt_dir)


def load_serving_meta(ckpt_dir: str) -> Dict:
    """The export's `serving_checkpoint.meta.json`, or {} without one."""
    p = path.join(ckpt_dir, SERVING_NAME + ".meta.json")
    if not path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)
