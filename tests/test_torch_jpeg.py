"""The port's JPEG decoder (cvpce_tpu_torch/data/jpeg.py and
csrc/jpeg_decode.cpp) against the decoders the JAX package calls:
`load_image` (PIL, convert("RGB") / 255) and `load_image_rgba` (cv2
IMREAD_UNCHANGED, BGR -> RGBA, / 255), both on libjpeg-turbo. Files
are written by PIL (qualities 50 / 75 / 95, subsamplings 4:4:4, 4:2:2
and 4:2:0, optimised Huffman tables), by cv2 (4:1:1, 4:4:0, 4:2:0 and
4:2:2 with restart intervals), by the port's `testing.write_jpeg`
(every sampling, restart intervals, SOF1 with 16-bit tables) and
patched, from seeded numpy arrays at 1x1, 2x3, 17x9, 61x97 and 33x200
pixels, grey among them. Tolerance: none, the decoded arrays are equal.
Then the plain versions (`decode_reference`, `reconstruct_reference`)
against the C++, the refusals (NotImplementedError naming the file and
the feature) and truncation (OSError wherever PIL's read is one)."""
import io

import cv2
import numpy as np
import pytest
from PIL import Image

from cvpce_tpu.data import transforms as j_T
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.data import jpeg
from cvpce_tpu_torch.data import transforms as T

SIZES = ((1, 1), (2, 3), (17, 9), (61, 97), (33, 200))
CV2_SAMPLINGS = {"4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                 "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                 "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                 "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}


def _photo(rng, h, w, c=3):
    """Smooth noise, so the coefficients are those of a photo rather
    than of white noise (a 5x5 blur where the image is large enough)."""
    a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if h >= 5 and w >= 5:
        a = cv2.GaussianBlur(a, (5, 5), 1.5).reshape(h, w, c)
    return a


def _same_as_jax(path):
    np.testing.assert_array_equal(T.load_image(path), j_T.load_image(path))
    np.testing.assert_array_equal(T.load_image_rgba(path),
                                  j_T.load_image_rgba(path))


def _plain_equal(data: bytes):
    """Both plain versions against the C++ decoder on `data`."""
    got = jpeg.decode_jpeg(data).samples
    coefs = jpeg.decode_coefficients(data)
    np.testing.assert_array_equal(jpeg.reconstruct_reference(
        coefs.coefficients, coefs.tables, coefs.sampling, coefs.size), got)
    np.testing.assert_array_equal(jpeg.decode_reference(data), got)
    ref = jpeg.decode_coefficients_reference(data)
    for a, b in zip(ref.coefficients, coefs.coefficients):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quality", (50, 75, 95))
@pytest.mark.parametrize("hw", SIZES)
def test_pil_files_read_as_jax(tmp_path, hw, quality):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1] + quality)
    arr = _photo(rng, *hw)
    for subsampling in (0, 1, 2):
        path = str(tmp_path / f"s{subsampling}.jpg")
        Image.fromarray(arr).save(path, format="JPEG", quality=quality,
                                  subsampling=subsampling, optimize=True)
        _same_as_jax(path)
    path = str(tmp_path / "grey.jpg")
    Image.fromarray(arr[..., 0]).save(path, format="JPEG", quality=quality)
    _same_as_jax(path)


@pytest.mark.parametrize("sampling", tuple(CV2_SAMPLINGS))
@pytest.mark.parametrize("hw", SIZES)
def test_cv2_files_with_restarts_read_as_jax(tmp_path, hw, sampling):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    arr = _photo(rng, *hw)
    for restart in (1, 3):
        path = str(tmp_path / f"r{restart}.jpg")
        assert cv2.imwrite(path, arr[..., ::-1], [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLINGS[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
            cv2.IMWRITE_JPEG_QUALITY, 85])
        _same_as_jax(path)
        with open(path, "rb") as f:
            _plain_equal(f.read())


@pytest.mark.parametrize("hw", SIZES)
def test_sof1_read_as_jax(tmp_path, hw):
    """A PIL file with its SOF0 marker patched into SOF1 (extended
    sequential, the same coding), colour and grey."""
    rng = np.random.default_rng(hw[0] + 7 * hw[1])
    arr = _photo(rng, *hw)
    for name, img in (("c.jpg", arr), ("g.jpg", arr[..., 0])):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=80)
        data = buf.getvalue()
        at = data.index(b"\xff\xc0")
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data[:at + 1] + b"\xc1" + data[at + 2:])
        _same_as_jax(path)
        assert jpeg.decode_coefficients(data).sof == 0xC0
        with open(path, "rb") as f:
            assert jpeg.decode_coefficients(f.read()).sof == 0xC1


@pytest.mark.parametrize("sampling",
                         tuple(testing.JPEG_SAMPLINGS) + ("grey",))
def test_write_jpeg_read_by_pil_as_by_the_port(tmp_path, sampling):
    """testing.write_jpeg's files: PIL reads them as the port does, and
    the coefficients it returns are those the port decodes; both plain
    versions equal the C++."""
    rng = np.random.default_rng(len(sampling))
    for hw in SIZES:
        arr = _photo(rng, *hw)
        for restart, sof in ((0, 0xC0), (2, 0xC0), (1, 0xC1)):
            path = str(tmp_path / f"{restart}.jpg")
            wrote = testing.write_jpeg(
                path, arr[..., 0] if sampling == "grey" else arr,
                quality=70, sampling="4:2:0" if sampling == "grey"
                else sampling, restart_interval=restart, sof=sof)
            _same_as_jax(path)
            with open(path, "rb") as f:
                data = f.read()
            coefs = jpeg.decode_coefficients(data)
            assert coefs.restart_interval == restart and coefs.sof == sof
            assert len(wrote) == len(coefs.coefficients)
            for a, b in zip(wrote, coefs.coefficients):
                np.testing.assert_array_equal(a, b)
            _plain_equal(data)


def test_plain_versions_on_pil_files():
    rng = np.random.default_rng(11)
    for hw in SIZES:
        arr = _photo(rng, *hw)
        for subsampling in (0, 1, 2):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=60,
                                      subsampling=subsampling,
                                      optimize=True)
            _plain_equal(buf.getvalue())


def _pil_bytes(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _patch(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    at = data.index(marker) + offset
    return data[:at] + bytes([value]) + data[at + 1:]


def test_refusals_name_the_file_and_the_feature(tmp_path):
    rng = np.random.default_rng(12)
    img = Image.fromarray(_photo(rng, 24, 40))
    base = _pil_bytes(img)
    cases = {
        "progressive": (_pil_bytes(img, progressive=True), "progressive"),
        "cmyk": (_pil_bytes(img.convert("CMYK")), "CMYK"),
        "sof9": (_patch(base, b"\xff\xc0", 1, 0xC9), "arithmetic"),
        "12bit": (_patch(base, b"\xff\xc0", 4, 12), "12-bit"),
        "rgb": (_pil_bytes(img, keep_rgb=True), "RGB JPEG"),
        "dnl": (_patch(_patch(base, b"\xff\xc0", 5, 0), b"\xff\xc0", 6, 0),
                "DNL"),
    }
    # PIL reads the first two and the RGB file
    for name in ("progressive", "cmyk", "rgb"):
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(cases[name][0])
        assert j_T.load_image(path).shape == (24, 40, 3)
    for name, (data, match) in cases.items():
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for load in (T.load_image, T.load_image_rgba):
            with pytest.raises(NotImplementedError, match=match) as err:
                load(path)
            assert path in str(err.value)
            assert not isinstance(err.value, OSError)


def test_truncation_raises_oserror_where_pil_does(tmp_path):
    """Cut inside the headers, inside the entropy-coded data and before
    the EOI alone: PIL raises OSError at each cut, so does the port."""
    rng = np.random.default_rng(13)
    arr = _photo(rng, 61, 97)
    path = str(tmp_path / "whole.jpg")
    assert cv2.imwrite(path, arr[..., ::-1], [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    with open(path, "rb") as f:
        data = f.read()
    assert data.endswith(b"\xff\xd9")
    sos = data.index(b"\xff\xda")
    cuts = sorted({3, 20, sos - 5, sos + 4, sos + 20,
                   (sos + len(data)) // 2, len(data) - 9, len(data) - 2,
                   len(data) - 1})
    cut = str(tmp_path / "cut.jpg")
    for n in cuts:
        with open(cut, "wb") as f:
            f.write(data[:n])
        with pytest.raises(OSError):
            j_T.load_image(cut)
        with pytest.raises(OSError) as err:
            T.load_image(cut)
        assert cut in str(err.value), n
    # a restart marker out of sequence is corrupt data
    at = data.index(b"\xff\xd1")
    with open(cut, "wb") as f:
        f.write(data[:at + 1] + b"\xd5" + data[at + 2:])
    with pytest.raises(OSError, match="RST1"):
        T.load_image(cut)


def test_format_goes_by_signature(tmp_path):
    """JPEG bytes under any name decode as JPEG; unknown bytes raise
    OSError as PIL's "cannot identify image file"."""
    rng = np.random.default_rng(14)
    path = str(tmp_path / "scene.png")
    Image.fromarray(_photo(rng, 9, 13)).save(path, format="JPEG")
    _same_as_jax(path)
    noise = str(tmp_path / "noise.jpg")
    with open(noise, "wb") as f:
        f.write(b"\xff\xd8\x00" + bytes(range(61)))
    with pytest.raises(OSError, match="cannot identify"):
        T.load_image(noise)
    with pytest.raises(OSError):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xd9", "empty")
