"""The port's JPEG decoder (cvpce_tpu_torch/data/jpeg.py and
csrc/jpeg_decode.cpp) on the files beside baseline JPEG that the JAX
package's `load_image` (PIL, convert("RGB")) and `load_image_rgba` (cv2
IMREAD_UNCHANGED as RGBA) read: progressive files from PIL and cv2
(samplings 4:4:4, 4:2:2, 4:2:0 and cv2's 4:1:1 / 4:4:0, qualities 50
and 90, with and without `optimize`, restart intervals), sequential
files with one scan a component or components split over scans, CMYK
and YCCK (Adobe transforms 0 and 2, and four components with no Adobe
marker), and RGB (Adobe transform 0, and component ids 'R' 'G' 'B' with
neither marker); files from PIL, cv2 and `testing.write_jpeg` in each
of its modes, from seeded numpy arrays at 1x1 to 61x97 pixels, and the
committed fixtures against their digests, and progressive files cut
short, which libjpeg decodes with block smoothing. Tolerance: none, the decoded
arrays are equal. Then the plain versions (`decode_reference`,
`reconstruct_reference`) against the C++ on small progressive, multi-scan
and four-component files, and truncation inside a later scan (OSError
where PIL's read is one)."""
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from cvpce_tpu.data import transforms as j_T
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.data import jpeg
from cvpce_tpu_torch.data import transforms as T

SIZES = ((1, 1), (17, 9), (61, 97))
PIL_SUBSAMPLINGS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
CV2_SAMPLINGS = {"4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                 "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                 "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# testing.write_jpeg's new modes: (channels, keyword arguments)
WRITE_MODES = {
    "progressive": (3, dict(progressive=True)),
    "progressive_grey": (1, dict(progressive=True)),
    "progressive_rgb": (3, dict(progressive=True, colour="rgb")),
    "progressive_cmyk": (4, dict(progressive=True)),
    "progressive_ycck": (4, dict(progressive=True, colour="ycck")),
    "scan_a_component": (3, dict(scans="components")),
    "scans_y_then_cbcr": (3, dict(scans=((0,), (2, 1)))),
    "cmyk": (4, {}),
    "cmyk_scan_a_component": (4, dict(scans="components")),
    "ycck": (4, dict(colour="ycck")),
    "rgb": (3, dict(colour="rgb")),
    "rgb_scan_a_component": (3, dict(colour="rgb", scans="components")),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_train_dihe_loops.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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
        coefs.coefficients, coefs.tables, coefs.sampling, coefs.size,
        coefs.colour), got)
    np.testing.assert_array_equal(jpeg.decode_reference(data), got)
    ref = jpeg.decode_coefficients_reference(data)
    assert ref.colour == coefs.colour and ref.sof == coefs.sof
    for a, b in zip(ref.coefficients, coefs.coefficients):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref.tables, coefs.tables):
        np.testing.assert_array_equal(a, b)


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.mark.parametrize("quality", (50, 90))
@pytest.mark.parametrize("subsampling", tuple(PIL_SUBSAMPLINGS))
@pytest.mark.parametrize("hw", SIZES)
def test_pil_progressive_files_read_as_jax(tmp_path, hw, subsampling,
                                           quality):
    """PIL's progressive files (libjpeg's jpeg_simple_progression: DC
    first and refinement, AC bands at Al 2 and 1, refinement to bit 0,
    optimised tables in a DHT before each scan), with and without
    `optimize` and with restart intervals (`restart_marker_blocks`),
    colour and grey."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1] + quality)
    arr = _photo(rng, *hw)
    cases = {"plain": {}, "optimize": dict(optimize=True),
             "restart": dict(restart_marker_blocks=2)}
    for name, kw in cases.items():
        path = str(tmp_path / f"{name}.jpg")
        Image.fromarray(arr).save(
            path, format="JPEG", quality=quality, progressive=True,
            subsampling=PIL_SUBSAMPLINGS[subsampling], **kw)
        _same_as_jax(path)
        coefs = jpeg.decode_coefficients(open(path, "rb").read())
        assert coefs.sof == 0xC2 and coefs.colour == "ycbcr"
        assert coefs.restart_interval == (2 if kw.get(
            "restart_marker_blocks") else 0)
    path = str(tmp_path / "grey.jpg")
    Image.fromarray(arr[..., 0]).save(path, format="JPEG", quality=quality,
                                      progressive=True)
    _same_as_jax(path)


@pytest.mark.parametrize("sampling", tuple(CV2_SAMPLINGS))
@pytest.mark.parametrize("hw", SIZES)
def test_cv2_progressive_files_with_restarts_read_as_jax(tmp_path, hw,
                                                         sampling):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1] + 5)
    arr = _photo(rng, *hw)
    for restart in (0, 1, 3):
        path = str(tmp_path / f"r{restart}.jpg")
        assert cv2.imwrite(path, arr[..., ::-1], [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLINGS[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
            cv2.IMWRITE_JPEG_QUALITY, 85])
        _same_as_jax(path)
        with open(path, "rb") as f:
            _plain_equal(f.read())


@pytest.mark.parametrize("mode", tuple(WRITE_MODES))
def test_write_jpeg_modes_read_by_pil_and_cv2_as_by_the_port(tmp_path,
                                                             mode):
    """testing.write_jpeg's progressive, multi-scan, four-component and
    RGB files: PIL and cv2 read them as the port does, the coefficients
    it returns are those the port decodes, both plain versions equal the
    C++."""
    channels, kw = WRITE_MODES[mode]
    rng = np.random.default_rng(len(mode))
    for hw in SIZES:
        arr = _photo(rng, *hw, c=4)[..., :channels]
        for sampling, restart in (("4:2:0", 0), ("4:2:2", 2),
                                  ("4:4:4", 1), ("4:1:1", 0)):
            path = str(tmp_path / f"{restart}.jpg")
            wrote = testing.write_jpeg(path, arr, quality=70,
                                       sampling=sampling,
                                       restart_interval=restart, **kw)
            _same_as_jax(path)
            with open(path, "rb") as f:
                data = f.read()
            coefs = jpeg.decode_coefficients(data)
            assert coefs.restart_interval == restart
            assert coefs.sof == (0xC2 if kw.get("progressive") else 0xC0)
            assert coefs.colour == kw.get("colour", {
                1: "grey", 3: "ycbcr", 4: "cmyk"}[channels])
            assert len(wrote) == len(coefs.coefficients)
            for a, b in zip(wrote, coefs.coefficients):
                np.testing.assert_array_equal(a, b)
            _plain_equal(data)


def _drop_segment(data: bytes, marker: bytes) -> bytes:
    at = data.index(marker)
    length = int.from_bytes(data[at + 2:at + 4], "big")
    return data[:at] + data[at + 2 + length:]


@pytest.mark.parametrize("hw", SIZES + ((33, 200),))
def test_cmyk_ycck_and_rgb_through_both_reads(tmp_path, hw):
    """Four components from PIL (Adobe CMYK, baseline and progressive),
    the same with its Adobe marker dropped (CMYK, as libjpeg assumes),
    YCCK from write_jpeg; RGB from PIL's keep_rgb (Adobe transform 0)
    and write_jpeg's RGB file with its Adobe marker dropped (component
    ids 'R' 'G' 'B'). PIL's and cv2's reads of CMYK differ in rounding:
    to_rgb follows PIL and to_rgba cv2."""
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    cmyk = _photo(rng, *hw, c=4)
    rgb = cmyk[..., :3]
    files = {}
    for name, kw in (("cmyk", {}), ("cmyk_progressive",
                                    dict(progressive=True))):
        buf = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(buf, format="JPEG", quality=85,
                                           **kw)
        files[name] = buf.getvalue()
    files["cmyk_no_adobe"] = _drop_segment(files["cmyk"], b"\xff\xee")
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=85, keep_rgb=True)
    files["keep_rgb"] = buf.getvalue()
    testing.write_jpeg(tmp_path / "w.jpg", rgb, colour="rgb",
                       sampling="4:2:2")
    files["rgb_ids"] = _drop_segment((tmp_path / "w.jpg").read_bytes(),
                                     b"\xff\xee")
    testing.write_jpeg(tmp_path / "w.jpg", cmyk, colour="ycck",
                       sampling="4:2:0", restart_interval=1)
    files["ycck"] = (tmp_path / "w.jpg").read_bytes()
    expect = {"cmyk": "cmyk", "cmyk_progressive": "cmyk",
              "cmyk_no_adobe": "cmyk", "keep_rgb": "rgb", "rgb_ids": "rgb",
              "ycck": "ycck"}
    for name, data in files.items():
        path = _write(tmp_path / f"{name}.jpg", data)
        _same_as_jax(path)
        assert jpeg.decode_coefficients(data).colour == expect[name]
        _plain_equal(data)
    if hw[0] * hw[1] > 1000:  # the two libraries' CMYK reads differ
        path = str(tmp_path / "cmyk.jpg")
        assert not np.array_equal(j_T.load_image(path),
                                  j_T.load_image_rgba(path)[..., :3])


def test_committed_fixtures_match_their_digests():
    """The files of tests/torch_fixtures/jpeg_features (PIL and cv2
    progressive, CMYK, Adobe RGB, and five progressive files cut short,
    which libjpeg decodes with block smoothing): the port's reads equal
    the digests of the JAX package's reads that
    scripts/write_jpeg_fixtures.py recorded, and the JAX package's reads
    here still give them."""
    with open(testing.JPEG_DIGESTS) as f:
        digests = json.load(f)
    assert len(digests) == 14
    assert sum(name.startswith("pil_smooth_") for name in digests) == 5
    for name, want in digests.items():
        path = os.path.join(testing.JPEG_FIXTURE_DIR, name)
        for load, j_load, key in ((T.load_image, j_T.load_image, "rgb"),
                                  (T.load_image_rgba, j_T.load_image_rgba,
                                   "rgba")):
            assert testing.pixel_digest(load(path)) == want[key], name
            assert testing.pixel_digest(j_load(path)) == want[key], name


def _progressive(arr, writer) -> bytes:
    """`arr` as a progressive JPEG: PIL's at 4:4:4, 4:2:2, 4:2:0, grey
    or CMYK, or cv2's at 4:1:1 / 4:4:0 with a restart every 2 MCUs."""
    if writer.startswith("cv2"):
        factor = CV2_SAMPLINGS["4:1:1" if writer == "cv2_411" else "4:4:0"]
        return cv2.imencode(".jpg", arr[..., :3], [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])[1].tobytes()
    buf = io.BytesIO()
    if writer == "pil_cmyk":
        img, kw = Image.fromarray(arr, "CMYK"), {}
    elif writer == "pil_grey":
        img, kw = Image.fromarray(arr[..., 0]), {}
    else:
        img = Image.fromarray(arr[..., :3])
        kw = {"subsampling": PIL_SUBSAMPLINGS[writer[4:]]}
    img.save(buf, format="JPEG", quality=85, progressive=True, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("writer", (
    "pil_4:4:4", "pil_4:2:2", "pil_4:2:0", "pil_grey", "pil_cmyk",
    "cv2_411", "cv2_440"))
@pytest.mark.parametrize("hw", ((8, 8), (17, 9), (40, 16), (61, 97)))
def test_block_smoothing_reads_as_jax(tmp_path, hw, writer):
    """A progressive file cut after each of its scans (an EOI after
    them): every cut but the last leaves low-frequency coefficients
    unrefined, and libjpeg smooths the blocks from their neighbours' DC
    values (the DC itself too where no AC scan came). The port's two
    reads equal the JAX package's (PIL, cv2) bit for bit, at one and two
    blocks across (the narrow windows of libjpeg's sliding DC
    registers), at odd sizes, on four components and with restarts."""
    rng = np.random.default_rng(23)
    data = _progressive(_photo(rng, *hw, c=4), writer)
    scans = [i for i in range(len(data) - 1)
             if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) == {"pil_grey": 6, "pil_cmyk": 18}.get(writer, 10)
    for k, start in enumerate(scans[1:], 1):
        path = _write(tmp_path / f"cut{k}.jpg", data[:start] + b"\xff\xd9")
        _same_as_jax(path)


def test_plain_versions_on_progressive_files():
    """decode_reference and reconstruct_reference against the C++ on
    PIL's progressive files: grey, the three samplings, CMYK."""
    rng = np.random.default_rng(21)
    for hw in ((9, 14), (24, 40)):
        arr = _photo(rng, *hw, c=4)
        for sub in PIL_SUBSAMPLINGS.values():
            buf = io.BytesIO()
            Image.fromarray(arr[..., :3]).save(
                buf, format="JPEG", quality=60, progressive=True,
                subsampling=sub)
            _plain_equal(buf.getvalue())
        for img in (Image.fromarray(arr[..., 0]),
                    Image.fromarray(arr, "CMYK")):
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=60, progressive=True)
            _plain_equal(buf.getvalue())


@pytest.mark.parametrize("writer", ("pil", "cv2_restart"))
def test_progressive_truncation_raises_oserror_where_pil_does(tmp_path,
                                                              writer):
    """A progressive file cut inside its first, a middle and its last
    scan, between scans and before its EOI alone: PIL raises OSError
    at each cut, so does the port."""
    rng = np.random.default_rng(22)
    arr = _photo(rng, 61, 97)
    path = str(tmp_path / "whole.jpg")
    if writer == "pil":
        Image.fromarray(arr).save(path, format="JPEG", progressive=True)
    else:
        assert cv2.imwrite(path, arr[..., ::-1], [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    data = open(path, "rb").read()
    scans = [i for i in range(len(data) - 1)
             if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) == 10
    cuts = sorted({scans[0] + 20, scans[4] - 3, scans[4] + 30,
                   (scans[7] + scans[8]) // 2, scans[9] + 40,
                   len(data) - 9, len(data) - 2, len(data) - 1})
    cut = str(tmp_path / "cut.jpg")
    for n in cuts:
        _write(cut, data[:n])
        with pytest.raises(OSError):
            j_T.load_image(cut)
        with pytest.raises(OSError) as err:
            T.load_image(cut)
        assert cut in str(err.value), n
