"""Write the committed JPEG fixtures of the port's decoder (run from the
repository root, on the CPU, with the JAX package, PIL and cv2
installed):

- tests/torch_fixtures/jpeg_features/: small seeded photos written by
  PIL and cv2 in the kinds the port's decoder reads beside baseline
  JPEG: progressive at 4:4:4, 4:2:2 and 4:2:0 (and with `optimize`),
  cv2's progressive file with a restart interval, grey progressive,
  PIL's CMYK (baseline and progressive), PIL's `keep_rgb=True`
  (Adobe transform 0), and PIL's progressive files cut after their
  first scans, which libjpeg decodes with block smoothing: the DC scan
  alone (4:2:0 and grey), the first AC scans at a point transform above
  0, luma never refined to bit 0, chroma with its DC alone (4:4:4);
- tests/torch_fixtures/jpeg_digests.json: for each file, the
  `testing.pixel_digest` of the JAX package's `load_image` (PIL's
  convert("RGB")) and `load_image_rgba` (cv2's IMREAD_UNCHANGED as
  RGBA) reads, and the image's size.

chip_smoke.py's data.jpeg phase and tests/test_torch_jpeg_features.py
hold the port's two readers to these digests.

    JAX_PLATFORMS=cpu python scripts/write_jpeg_fixtures.py
"""
import io
import json
import os
import sys

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cvpce_tpu.data import transforms as j_T  # noqa: E402
from cvpce_tpu_torch import testing  # noqa: E402

SEED = 2021
SIZE = (117, 163)  # odd on both axes: partial MCUs at every sampling


def photo(seed: int, channels: int = 3) -> np.ndarray:
    """Blurred noise over gradients: a photo's coefficients, not white
    noise's."""
    rng = np.random.default_rng((SEED, seed))
    h, w = SIZE
    noise = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    noise = cv2.GaussianBlur(noise, (7, 7), 2.0).reshape(h, w, channels)
    ramp = np.arange(w)[None, :, None] * 255 // w
    return ((noise.astype(np.int32) + ramp) // 2).astype(np.uint8)


def pil(name, arr, mode=None, **kw):
    Image.fromarray(arr, mode).save(name, format="JPEG", **kw)


def pil_cut(name, arr, scans, **kw):
    """PIL's progressive file of `arr` cut after its first `scans` scans,
    an EOI after them."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", progressive=True, **kw)
    data = buf.getvalue()
    starts = [i for i in range(len(data) - 1)
              if data[i:i + 2] == b"\xff\xda"]
    with open(name, "wb") as f:
        f.write(data[:starts[scans]] + b"\xff\xd9")


FILES = {
    "pil_progressive_444.jpg": lambda p: pil(
        p, photo(1), progressive=True, subsampling=0, quality=90),
    "pil_progressive_422.jpg": lambda p: pil(
        p, photo(2), progressive=True, subsampling=1, quality=75),
    "pil_progressive_420.jpg": lambda p: pil(
        p, photo(3), progressive=True, subsampling=2, quality=90),
    "pil_progressive_420_optimize.jpg": lambda p: pil(
        p, photo(4), progressive=True, subsampling=2, quality=60,
        optimize=True),
    "cv2_progressive_restart.jpg": lambda p: cv2.imwrite(p, photo(5), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_QUALITY,
        85]),
    "pil_progressive_grey.jpg": lambda p: pil(
        p, photo(6, 1)[..., 0], progressive=True, quality=85),
    "pil_cmyk.jpg": lambda p: pil(p, photo(7, 4), "CMYK", quality=90),
    "pil_cmyk_progressive.jpg": lambda p: pil(
        p, photo(8, 4), "CMYK", quality=80, progressive=True),
    "pil_keep_rgb.jpg": lambda p: pil(
        p, photo(9), quality=90, keep_rgb=True),
    "pil_smooth_dc_only_420.jpg": lambda p: pil_cut(
        p, photo(10), 1, subsampling=2, quality=90),
    "pil_smooth_ac_first_420.jpg": lambda p: pil_cut(
        p, photo(11), 5, subsampling=2, quality=90),
    "pil_smooth_luma_unrefined_420.jpg": lambda p: pil_cut(
        p, photo(12), 9, subsampling=2, quality=75),
    "pil_smooth_chroma_dc_only_444.jpg": lambda p: pil_cut(
        p, photo(13), 2, subsampling=0, quality=90),
    "pil_smooth_grey_dc_only.jpg": lambda p: pil_cut(
        p, photo(14, 1)[..., 0], 1, quality=85),
}


def main():
    os.makedirs(testing.JPEG_FIXTURE_DIR, exist_ok=True)
    digests = {}
    for name, write in FILES.items():
        path = os.path.join(testing.JPEG_FIXTURE_DIR, name)
        write(path)
        rgb = j_T.load_image(path)
        digests[name] = {"rgb": testing.pixel_digest(rgb),
                         "rgba": testing.pixel_digest(
                             j_T.load_image_rgba(path)),
                         "size": list(rgb.shape[:2]),
                         "bytes": os.path.getsize(path)}
        print(name, digests[name]["bytes"])
    with open(testing.JPEG_DIGESTS, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
