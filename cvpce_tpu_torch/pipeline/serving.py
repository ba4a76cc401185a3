"""Inference-only serving exports of the port's training runs, and the
loaders that read either layout; counterpart of
cvpce_tpu/pipeline/serving.py.

The training loops checkpoint the whole train state
(train/checkpoint.py: one `torch.save` file of a state's `state_dict()`:
for GLN the model, the SGD momentum buffers and the step; for DIHE the
three players, their Adam states and the step). Serving needs only the
model. An export is a directory holding:

- `serving_checkpoint`: one `torch.save` file, `{"model": state_dict}`
  for a GLN (the part that the JAX package's `params`, `frozen` and
  `batch_stats` play), `{"embedder": state_dict}` for a DIHE encoder;
- `serving_calibration.json` and `serving_checkpoint.meta.json`, copied
  byte for byte from the run, so that the calibrated threshold, the
  input preprocessing and the epoch travel with the weights
  (pipeline/calibrate.py).

The loaders take an export or a training-run directory (`checkpoint`,
`embedder_checkpoint`, or a named node such as `epoch_3`) and return the
model's state_dict, on the CPU. The JAX package's orbax directories,
whose `serving_checkpoint` or `checkpoint` entry is itself a directory,
raise `ValueError`: the port cannot read orbax (ROADMAP.md, Queue 1
item 7).
"""
from __future__ import annotations

import json
import os
import shutil
from os import path
from typing import Dict, Optional

import torch

from .calibrate import CALIBRATION_FILE

SERVING_NAME = "serving_checkpoint"
# the part of a port training checkpoint that serving keeps: the GLN
# loop's GLNTrainState (train/gln.py) its `model`, train_dihe's
# DIHETrainState (train/dihe.py) its `embedder`
GLN_PART = "model"
DIHE_PART = "embedder"


def _read(target: str) -> Dict:
    """The dict that `torch.save` wrote at `target`."""
    if path.isdir(target):
        raise ValueError(
            f"{target} is a directory: orbax checkpoints of the JAX "
            "package cannot be read by the port (ROADMAP.md, Queue 1 "
            "item 7)")
    if not path.exists(target):
        raise ValueError(
            f"no checkpoint file {target}: the directory is neither a "
            "port training run nor a port serving export (orbax "
            "checkpoints of the JAX package cannot be read by the port: "
            "ROADMAP.md, Queue 1 item 7)")
    obj = torch.load(target, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{target} holds a {type(obj).__name__}, not a "
                         "checkpoint dict")
    return obj


def _save(target: str, tree: Dict) -> None:
    tmp = target + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, target)


def _copy_sidecars(run_dir: str, out_dir: str, meta_src: str) -> None:
    cal = path.join(run_dir, CALIBRATION_FILE)
    if path.exists(cal):
        shutil.copyfile(cal, path.join(out_dir, CALIBRATION_FILE))
    meta = path.join(run_dir, meta_src + ".meta.json")
    if path.exists(meta):
        shutil.copyfile(meta,
                        path.join(out_dir, SERVING_NAME + ".meta.json"))


def _export(run_dir: str, out_dir: str, name: str, part: str) -> str:
    state = _read(path.join(run_dir, name))
    if part not in state:
        raise ValueError(f"{path.join(run_dir, name)} holds no '{part}' "
                         f"(keys: {sorted(map(str, state))})")
    os.makedirs(out_dir, exist_ok=True)
    _save(path.join(out_dir, SERVING_NAME), {part: state[part]})
    _copy_sidecars(run_dir, out_dir, name)
    return out_dir


def export_gln_serving(run_dir: str, out_dir: str,
                       name: str = "checkpoint") -> str:
    """Export a GLN training run's model state_dict, its calibration and
    meta sidecars to `out_dir`; the SGD buffers and the step stay
    behind."""
    return _export(run_dir, out_dir, name, GLN_PART)


def export_dihe_serving(run_dir: str, out_dir: str,
                        name: str = "embedder_checkpoint") -> str:
    """Export a DIHE run's encoder state_dict to `out_dir`. The GAN
    players and every optimizer state stay behind: eval needs only the
    embedder (cvpce/cli/dihe.py:301-309)."""
    return _export(run_dir, out_dir, name, DIHE_PART)


def _serving_path(ckpt_dir: str) -> Optional[str]:
    p = path.join(ckpt_dir, SERVING_NAME)
    return p if path.exists(p) else None


def load_gln_variables(ckpt_dir: str,
                       name: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """The GLN state_dict of a serving export or of a training-run
    directory's checkpoint `name`.

    The serving-export shortcut applies only for the default name: a
    caller that asked for a specific node (e.g. epoch_87) gets that node,
    not a serving export that sits in the same directory."""
    serving = _serving_path(ckpt_dir) if name == "checkpoint" else None
    state = _read(serving or path.join(ckpt_dir, name))
    if GLN_PART not in state:
        raise ValueError(f"{ckpt_dir} is not a GLN checkpoint: missing "
                         f"['{GLN_PART}'] (keys: {sorted(map(str, state))})")
    return state[GLN_PART]


def load_dihe_encoder(ckpt_dir: str, name: str = "embedder_checkpoint"
                      ) -> Dict[str, torch.Tensor]:
    """The MACVGG encoder state_dict of a DIHE serving export or of a
    training-run directory's checkpoint `name`.

    A GLN export or run is refused, as the JAX loader refuses a tree with
    a 'frozen' collection: loading foreign weights into the embedder
    would serve garbage."""
    serving = (_serving_path(ckpt_dir)
               if name == "embedder_checkpoint" else None)
    state = _read(serving or path.join(ckpt_dir, name))
    if GLN_PART in state:
        raise ValueError(
            f"{ckpt_dir} looks like a GLN checkpoint (has a '{GLN_PART}' "
            "entry), not a DIHE encoder")
    if DIHE_PART in state:
        return state[DIHE_PART]
    raise ValueError(f"{ckpt_dir} is not a DIHE checkpoint "
                     f"(keys: {sorted(map(str, state))})")


def load_serving_meta(ckpt_dir: str) -> Dict:
    """The export's `serving_checkpoint.meta.json`, or {} without one."""
    p = path.join(ckpt_dir, SERVING_NAME + ".meta.json")
    if not path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)
