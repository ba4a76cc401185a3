"""The port's PNG decoder (cvpce_tpu_torch/data/png.py) against the
decoders the JAX package calls: `load_image` (PIL, convert("RGB") /
255) and `load_image_rgba` (cv2 IMREAD_UNCHANGED, BGRA -> RGBA, / 255),
on files written by the port's `testing.write_png` (every colour type
and bit depth it reads, tRNS, each row filter), by PIL and by cv2, from
seeded numpy arrays. Tolerance: none, the decoded arrays are equal.
Then the C++ row unfilter against its numpy reference, and the
refusals: interlaced and 16-bit PNG, an arithmetic-coded JPEG and other
formats raise NotImplementedError naming the file, never an OSError
(baseline and progressive JPEG under a PNG name go to the JPEG decoder,
by their signature, and so does a progressive one cut short, which it
decodes with block smoothing); a truncated or corrupt PNG raises
OSError."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from cvpce_tpu.data import transforms as j_T
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.data import png
from cvpce_tpu_torch.data import transforms as T

WIDTHS = (1, 3, 17)
H = 7  # every filter of the default r % 5 cycle, two of them twice


def _case(kind, w, rng):
    """(array, write_png kwargs) of one colour-type case."""
    if kind.startswith("c"):  # grey, grey + alpha, RGB, RGBA
        c = int(kind[1])
        return rng.integers(0, 256, (H, w, c), dtype=np.uint8), {}
    if kind == "grey_trns":
        a = (rng.integers(0, 4, (H, w)) * 60).astype(np.uint8)
        return a, {"trns": struct.pack(">H", 60)}
    if kind == "rgb_trns":
        a = (rng.integers(0, 2, (H, w, 3)) * 100).astype(np.uint8)
        a[0, 0] = (100, 0, 100)
        return a, {"trns": struct.pack(">HHH", 100, 0, 100)}
    depth = int(kind[-1])
    if kind.startswith("grey"):
        return (rng.integers(0, 1 << depth, (H, w)).astype(np.uint8),
                {"bit_depth": depth})
    n = 1 << depth
    kw = {"bit_depth": depth,
          "palette": rng.integers(0, 256, (n, 3), dtype=np.uint8)}
    if kind.startswith("ptrns"):
        kw["trns"] = rng.integers(0, 256, max(1, n // 2),
                                  dtype=np.uint8).tobytes()
    return rng.integers(0, n, (H, w)).astype(np.uint8), kw


KINDS = (("c1", "c2", "c3", "c4", "grey_trns", "rgb_trns")
         + tuple(f"grey{d}" for d in (1, 2, 4))
         + tuple(f"pal{d}" for d in (1, 2, 4, 8))
         + tuple(f"ptrns{d}" for d in (1, 2, 4, 8)))


def _same_as_jax(path):
    np.testing.assert_array_equal(T.load_image(path), j_T.load_image(path))
    np.testing.assert_array_equal(T.load_image_rgba(path),
                                  j_T.load_image_rgba(path))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_write_png_files_decode_as_pil_and_cv2(tmp_path, kind, w):
    rng = np.random.default_rng((KINDS.index(kind), w))
    arr, kw = _case(kind, w, rng)
    path = str(tmp_path / "x.png")
    testing.write_png(path, arr, **kw)
    _same_as_jax(path)


@pytest.mark.parametrize("filt", testing.PNG_FILTERS)
def test_each_filter_forced(tmp_path, filt):
    rng = np.random.default_rng(3)
    for w, c in ((17, 3), (5, 4), (9, 1)):
        path = str(tmp_path / f"{filt}_{c}.png")
        arr = rng.integers(0, 256, (6, w, c), dtype=np.uint8)
        testing.write_png(path, arr, filters=filt)
        _same_as_jax(path)
        np.testing.assert_array_equal(png.read_png(path).samples, arr)


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("w", WIDTHS)
def test_files_written_by_pil_and_cv2(tmp_path, w):
    """libpng's and zlib's own choices of filters and compression."""
    rng = np.random.default_rng(w)
    rgba = rng.integers(0, 256, (11, w, 4), dtype=np.uint8)
    rgba[..., :3] //= 8  # runs of equal bytes: libpng picks mixed filters
    for mode, arr in (("L", rgba[..., 0]), ("LA", rgba[..., :2]),
                      ("RGB", rgba[..., :3]), ("RGBA", rgba)):
        path = str(tmp_path / f"pil_{mode}.png")
        Image.fromarray(np.ascontiguousarray(arr), mode).save(
            path, optimize=mode == "RGB")
        _same_as_jax(path)
    img = Image.fromarray(np.ascontiguousarray(rgba[..., :3])).quantize(7)
    img.save(tmp_path / "pil_P.png")
    img.save(tmp_path / "pil_P_trns.png", transparency=2)
    Image.fromarray(rgba[..., 0] > 127).save(tmp_path / "pil_1.png")
    for name in ("pil_P", "pil_P_trns", "pil_1"):
        _same_as_jax(str(tmp_path / f"{name}.png"))
    for c in (1, 3, 4):
        path = str(tmp_path / f"cv2_{c}.png")
        cv2.imwrite(path, np.ascontiguousarray(rgba[..., :c].squeeze()))
        _same_as_jax(path)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_unfilter_matches_reference(bpp):
    rng = np.random.default_rng(bpp)
    rows, stride = 23, 7 * bpp + 3
    raw = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(rows) % 5
    raw[3:8, 0] = rng.integers(0, 5, 5)
    got = png.unfilter(raw.ravel(), rows, stride, bpp)
    want = png.unfilter_reference(raw.ravel(), rows, stride, bpp)
    np.testing.assert_array_equal(got, want)
    raw[5, 0] = 5
    with pytest.raises(OSError, match="row filter 5 in row 5"):
        png.unfilter(raw.ravel(), rows, stride, bpp)


def _adam7_png(path, arr):
    """An interlaced RGB PNG of `arr`: the seven Adam7 passes, filter 0."""
    data = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = arr[y0::dy, x0::dx]
        if sub.size:
            data += b"".join(b"\0" + row.tobytes() for row in sub)
    h, w = arr.shape[:2]
    chunks = [testing._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                      2, 0, 0, 1)),
              testing._png_chunk(b"IDAT", zlib.compress(data)),
              testing._png_chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + b"".join(chunks))


def test_refusals_name_the_file_and_are_not_oserrors(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (9, 10, 3), dtype=np.uint8)
    interlaced = str(tmp_path / "interlaced.png")
    _adam7_png(interlaced, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(interlaced)), arr)
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, (arr[..., 0].astype(np.uint16) * 257))
    # JAX's load_image_rgba hands 16-bit samples on unscaled
    assert j_T.load_image_rgba(deep).max() > 1.0
    jpeg = str(tmp_path / "photo.png")  # JPEG bytes under a PNG name
    Image.fromarray(arr).save(jpeg, format="JPEG")
    _same_as_jax(jpeg)  # the signature sends it to data/jpeg.py
    progressive = str(tmp_path / "progressive.png")
    Image.fromarray(arr).save(progressive, format="JPEG", progressive=True)
    _same_as_jax(progressive)
    # without its last scan libjpeg smooths the blocks, as the port does
    data = open(progressive, "rb").read()
    smoothed = str(tmp_path / "smoothed.png")
    open(smoothed, "wb").write(data[:data.rindex(b"\xff\xda")] + b"\xff\xd9")
    _same_as_jax(smoothed)
    # an arithmetic-coded frame (SOF9) is refused
    data = open(jpeg, "rb").read()
    at = data.index(b"\xff\xc0") + 1
    arithmetic = str(tmp_path / "arithmetic.png")
    open(arithmetic, "wb").write(data[:at] + b"\xc9" + data[at + 1:])
    bmp = str(tmp_path / "photo.bmp")
    cv2.imwrite(bmp, arr)
    assert j_T.load_image(bmp).shape == (9, 10, 3)
    for path, match in ((interlaced, "interlaced"), (deep, "16-bit"),
                        (arithmetic, "arithmetic"), (bmp, "BMP")):
        for load in (T.load_image, T.load_image_rgba):
            with pytest.raises(NotImplementedError, match=match) as err:
                load(path)
            assert path in str(err.value)
            assert not isinstance(err.value, OSError)


def test_truncated_and_corrupt_png_raise_oserror(tmp_path):
    rng = np.random.default_rng(6)
    good = str(tmp_path / "good.png")
    testing.write_png(good, rng.integers(0, 256, (40, 30, 3),
                                         dtype=np.uint8))
    data = open(good, "rb").read()
    cut = str(tmp_path / "cut.png")
    open(cut, "wb").write(data[:len(data) // 2])
    flipped = bytearray(data)
    flipped[len(data) // 2] ^= 0x40
    corrupt = str(tmp_path / "corrupt.png")
    open(corrupt, "wb").write(bytes(flipped))
    unknown = str(tmp_path / "noise.png")
    open(unknown, "wb").write(bytes(range(64)))
    for path in (cut, unknown):
        with pytest.raises(OSError):
            j_T.load_image(path)
    for path in (cut, corrupt, unknown):
        with pytest.raises(OSError) as err:
            T.load_image(path)
        assert path in str(err.value)
