"""The port's baseline JPEG writer (cvpce_tpu_torch/data/jpeg.py:
encode_jpeg / save_jpeg over csrc/jpeg_encode.cpp) against what the JAX
package writes with cv2.imwrite: the same bytes as cv2.imencode(".jpg")
at OpenCV's defaults (quality 95, 4:2:0, JFIF, standard Huffman
tables), grey and colour, at sizes with partial blocks and MCUs on
either axis, on white noise (large coefficients, long codes) and on a
smooth photo; and PIL's read of each file equal to the port's decode.
Tolerance: none."""
import io

import cv2
import numpy as np
import pytest
from PIL import Image

from cvpce_tpu_torch.data import jpeg

SIZES = ((1, 1), (7, 9), (16, 16), (33, 17), (120, 160))


def _images(rng, h, w):
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([128 + 100 * np.sin(xx / 7 + c) * np.cos(yy / 5 - c)
                       for c in range(3)], -1)
    return {"noise": noise, "smooth": np.rint(smooth).astype(np.uint8)}


@pytest.mark.parametrize("colour", (True, False))
@pytest.mark.parametrize("hw", SIZES)
def test_encoder_writes_cv2s_bytes(hw, colour):
    rng = np.random.default_rng(31)
    for name, rgb in _images(rng, *hw).items():
        px = rgb if colour else rgb[..., 1]
        got = jpeg.encode_jpeg(px)
        want = cv2.imencode(".jpg", px[..., ::-1] if colour else px)[1]
        assert got == want.tobytes(), name
        if not colour:
            assert jpeg.encode_jpeg(px[..., None]) == got
        pil = np.asarray(Image.open(io.BytesIO(got)).convert("RGB"))
        np.testing.assert_array_equal(
            jpeg.to_rgb(jpeg.decode_jpeg(got)), pil, err_msg=name)


def test_save_jpeg_writes_the_file_cv2_imwrite_writes(tmp_path):
    rgb = _images(np.random.default_rng(32), 61, 97)["noise"]
    jpeg.save_jpeg(tmp_path / "port.jpg", rgb)
    assert cv2.imwrite(str(tmp_path / "cv2.jpg"), rgb[..., ::-1])
    assert (tmp_path / "port.jpg").read_bytes() == \
        (tmp_path / "cv2.jpg").read_bytes()


def test_encoder_refuses_what_it_cannot_write():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    for shape in ((4, 4, 2), (4, 4, 4), (4,), (0, 4, 3), (4, 70000)):
        with pytest.raises(ValueError):
            jpeg.encode_jpeg(np.zeros(shape, np.uint8))
