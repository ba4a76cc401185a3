"""Serving-export metadata; counterpart of the json part of
cvpce_tpu/pipeline/serving.py. The orbax weight loaders stay in the JAX
package (the card's machine has no orbax)."""
from __future__ import annotations

import json
from os import path
from typing import Dict

SERVING_NAME = "serving_checkpoint"


def load_serving_meta(ckpt_dir: str) -> Dict:
    """The export's `serving_checkpoint.meta.json`, or {} without one."""
    p = path.join(ckpt_dir, SERVING_NAME + ".meta.json")
    if not path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)
