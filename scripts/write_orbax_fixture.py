"""Write the committed fixtures of the port's orbax reader (run from
the repository root, on the CPU, with the JAX package installed):

- tests/torch_fixtures/orbax_seeded/: `testing.orbax_fixture_tree()`
  saved by the JAX package's serving `_save` (orbax
  StandardCheckpointer, OCDBT + zarr v2 + zstd);
- tests/torch_fixtures/zstd_frames.{bin,json}: zstd frames of
  `testing.zstd_fixture_data` written by the `zstandard` module at
  levels -5, 1, 3 and 19, with and without checksum and content size,
  a multi-block frame, and two frames with a skippable frame between;
- tests/torch_fixtures/orbax_digests.json: sha256, shape and dtype of
  every leaf of the eight exports under artifacts/, from orbax's
  restore.

    JAX_PLATFORMS=cpu python scripts/write_orbax_fixture.py
"""
import glob
import json
import os
import struct
import sys

import numpy as np
import zstandard

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cvpce_tpu.pipeline.serving import _raw_restore, _save  # noqa: E402
from cvpce_tpu_torch import testing  # noqa: E402

FRAMES = [  # (name, data kind, level, checksum, content size)
    *[(f"text_l{lvl}_{tag}", "text", lvl, flags, flags)
      for lvl in (-5, 1, 3, 19) for tag, flags in (("plain", False),
                                                   ("sized", True))],
    ("noise_l3", "noise", 3, True, True),
    ("run_l3", "run", 3, True, False),
    ("f32q_l19", "f32q", 19, True, True),
]


def frames():
    blob, index = b"", []
    for name, kind, level, checksum, size in FRAMES:
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum,
            write_content_size=size).compress(
                testing.zstd_fixture_data(kind))
        index.append({"name": name, "parts": [kind], "offset": len(blob),
                      "length": len(frame)})
        blob += frame
    # two frames back to back with a skippable frame between them
    pair = (zstandard.ZstdCompressor(level=1).compress(
                testing.zstd_fixture_data("text"))
            + struct.pack("<II", 0x184D2A53, 7) + b"skipped"
            + zstandard.ZstdCompressor(level=3).compress(
                testing.zstd_fixture_data("run")))
    index.append({"name": "text_skip_run", "parts": ["text", "run"],
                  "offset": len(blob), "length": len(pair)})
    blob += pair
    with open(testing.ZSTD_FRAMES + ".bin", "wb") as f:
        f.write(blob)
    with open(testing.ZSTD_FRAMES + ".json", "w") as f:
        json.dump(index, f, indent=1)


def main():
    os.makedirs(os.path.dirname(testing.ORBAX_FIXTURE_DIR), exist_ok=True)
    _save(testing.ORBAX_FIXTURE_DIR, testing.orbax_fixture_tree())
    frames()
    digests = {}
    for d in sorted(glob.glob("artifacts/*/serving_checkpoint")):
        name = d.split("/")[1]
        digests[name] = testing.tree_digests(
            _raw_restore(os.path.abspath(d)))
    with open(testing.ORBAX_DIGESTS, "w") as f:
        json.dump(digests, f, indent=0, sort_keys=True)
    print({k: len(v) for k, v in digests.items()})


if __name__ == "__main__":
    main()
