"""PNG decoder of the port: the card's machine has no image library.

The JAX package decodes with PIL (`load_image`) and cv2
(`load_image_rgba`). The port reads PNG itself: the signature, then the
chunks (IHDR, PLTE, tRNS, IDAT, IEND; other ancillary chunks are
skipped), each checked against its CRC with `zlib.crc32`; the joined
IDAT data is inflated with `zlib`, and the five row filters are undone
by `csrc/png_unfilter.cpp` (g++, ctypes, built on first use by
`_build.load`; where it does not build, decoding raises: there is no
numpy route on the main path). `unfilter_reference` is the plain numpy
version the tests hold the C++ against.

Supported: bit depth 8 for grey, RGB, grey + alpha and RGBA (colour
types 0, 2, 4, 6), grey at 1, 2 and 4 bits, and palette images (type 3)
at 1, 2, 4 and 8 bits, with tRNS. `to_rgb` gives PIL's
`convert("RGB")` (alpha and tRNS dropped, not composited) and
`to_rgba` cv2's `IMREAD_UNCHANGED` read turned from BGRA into RGBA
(grey expanded, tRNS applied where cv2 applies it, alpha 255 where
there is none), byte for byte.

Refused: Adam7 interlacing and 16-bit samples raise NotImplementedError
naming the file, as do JPEG, GIF, BMP, TIFF and WebP files, which PIL
and cv2 read and the port does not. The type is deliberately not an
OSError: the SKU-110K reader replaces an image that raises OSError with
item 0. A truncated or corrupt PNG raises OSError, as PIL does. The
format is taken from the file's signature, never its extension.
"""
from __future__ import annotations

import ctypes
import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

from .. import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, bit depths the specification allows)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
               3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"),
                  (b"GIF89a", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


@dataclasses.dataclass
class PNGImage:
    """A decoded PNG before colour conversion. `samples` is (H, W, C)
    uint8: palette indices for colour type 3, grey values as stored
    (not yet scaled to 8 bits) at bit depths below 8."""
    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: Optional[np.ndarray] = None  # (N, 3) uint8
    trns: Optional[bytes] = None


def _lib() -> ctypes.CDLL:
    lib = _build.load("png_unfilter")
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_void_p]
    return lib


def unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int,
             name: str = "<png>") -> np.ndarray:
    """The C++ unfilter: `raw` holds rows x (1 + stride) filtered bytes;
    returns the (rows, stride) reconstructed bytes."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < rows * (stride + 1):
        raise ValueError(f"{raw.size} bytes for {rows} rows of {stride}")
    out = np.empty((rows, stride), np.uint8)
    bad = _lib().png_unfilter(raw.ctypes.data, rows, stride, bpp,
                              out.ctypes.data)
    if bad:
        raise OSError(f"{name}: unknown PNG row filter "
                      f"{raw[(bad - 1) * (stride + 1)]} in row {bad - 1}")
    return out


def unfilter_reference(raw: np.ndarray, rows: int, stride: int,
                       bpp: int) -> np.ndarray:
    """Plain numpy version of `unfilter` (a Python loop over the bytes
    of Average and Paeth rows), for the tests."""
    raw = np.asarray(raw, np.uint8)[:rows * (stride + 1)].reshape(
        rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for r in range(rows):
        kind, line = int(raw[r, 0]), raw[r, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            cur = np.zeros(stride, np.int64)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise OSError(f"unknown PNG row filter {kind} in row {r}")
        out[r] = cur
        prev = cur
    return out


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """(H, stride) reconstructed bytes -> (H, W, C) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, rows.shape[1] * per_byte)[:, :width, None]


def _refuse_other_format(data: bytes, name: str) -> None:
    fmt = next((f for sig, f in _OTHER_FORMATS if data.startswith(sig)),
               None)
    if fmt is None and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        fmt = "WebP"
    if fmt is not None:
        raise NotImplementedError(
            f"{name}: {fmt} file; the port decodes PNG only (a JPEG "
            "decoder is ROADMAP.md Queue 1 item 6c)")
    raise OSError(f"cannot identify image file {name}")


def decode_png(data: bytes, name: str = "<bytes>") -> PNGImage:
    """Decode PNG bytes; `name` goes into every error."""
    if not data.startswith(SIGNATURE):
        _refuse_other_format(data, name)
    pos = len(SIGNATURE)
    header = palette = trns = None
    idat = []
    while True:
        if pos + 8 > len(data):
            raise OSError(f"{name}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise OSError(f"{name}: truncated PNG ({kind!r} chunk cut)")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise OSError(f"{name}: broken PNG (CRC of the {kind!r} chunk)")
        pos = end
        if header is None and kind != b"IHDR":
            raise OSError(f"{name}: broken PNG (no IHDR first)")
        if kind == b"IHDR":
            if length != 13:
                raise OSError(f"{name}: broken PNG (IHDR of {length} bytes)")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise OSError(f"{name}: broken PNG (PLTE of {length} bytes)")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:
            raise OSError(f"{name}: unknown critical PNG chunk {kind!r}")

    width, height, depth, color_type, compression, filt, interlace = header
    if color_type not in COLOR_TYPES or \
            depth not in COLOR_TYPES[color_type][1] or compression or filt \
            or interlace > 1 or not width or not height:
        raise OSError(f"{name}: broken PNG header {header}")
    if interlace:
        raise NotImplementedError(
            f"{name}: interlaced (Adam7) PNG; the port reads "
            "non-interlaced PNG only")
    if depth == 16:
        raise NotImplementedError(
            f"{name}: 16-bit PNG; the port reads 8-bit samples and "
            "palettes of 1-8 bits only")
    channels = COLOR_TYPES[color_type][0]
    stride = (width * channels * depth + 7) // 8
    expected = height * (stride + 1)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), expected)
    except zlib.error as e:
        raise OSError(f"{name}: broken PNG data ({e})") from None
    if len(raw) < expected:
        raise OSError(f"{name}: image file is truncated "
                      f"({len(raw)} of {expected} bytes)")
    rows = unfilter(np.frombuffer(raw, np.uint8), height, stride,
                    max(channels * depth // 8, 1), name)
    samples = _unpack(rows, width, channels, depth)
    if color_type == 3:
        if palette is None:
            raise OSError(f"{name}: broken PNG (palette image, no PLTE)")
        if int(samples.max()) >= len(palette):
            raise OSError(f"{name}: broken PNG (palette index past "
                          f"{len(palette)} entries)")
    return PNGImage(samples, color_type, depth, palette, trns)


def read_png(path) -> PNGImage:
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def _grey8(img: PNGImage) -> np.ndarray:
    """(H, W) grey scaled to 8 bits (0-3 x 85, 0-15 x 17, 0-1 x 255)."""
    g = img.samples[..., 0]
    if img.bit_depth < 8:
        g = g * np.uint8(255 // ((1 << img.bit_depth) - 1))
    return g


def to_rgb(img: PNGImage) -> np.ndarray:
    """(H, W, 3) uint8: PIL's `convert("RGB")` of the image."""
    t = img.color_type
    if t == 3:
        return img.palette[img.samples[..., 0]]
    if t in (0, 4):
        return np.repeat(_grey8(img)[..., None], 3, axis=-1)
    return np.ascontiguousarray(img.samples[..., :3])


def to_rgba(img: PNGImage) -> np.ndarray:
    """(H, W, 4) uint8: cv2.imread(IMREAD_UNCHANGED) turned into RGBA
    as the JAX package's `load_image_rgba` does. cv2 applies tRNS to
    palette and RGB images (alpha 0 on the transparent colour) and not
    to grey ones."""
    t, s = img.color_type, img.samples
    h, w = s.shape[:2]
    if t == 6:
        return np.ascontiguousarray(s)
    alpha = np.full((h, w), 255, np.uint8)
    if t == 3:
        rgb = img.palette[s[..., 0]]
        if img.trns:
            table = np.full(256, 255, np.uint8)
            table[:len(img.trns)] = np.frombuffer(img.trns, np.uint8)[:256]
            alpha = table[s[..., 0]]
    elif t == 2:
        rgb = s
        if img.trns is not None and len(img.trns) == 6:
            key = np.array(struct.unpack(">HHH", img.trns))
            alpha[(s == key).all(-1)] = 0
    else:
        rgb = np.repeat(_grey8(img)[..., None], 3, axis=-1)
        if t == 4:
            alpha = s[..., 1]
    return np.concatenate([rgb, alpha[..., None]], axis=-1)
