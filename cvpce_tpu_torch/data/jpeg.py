"""JPEG decoder of the port: the card's machine has no image library.

The JAX package decodes with PIL (`load_image`) and cv2
(`load_image_rgba`), both on libjpeg-turbo. The port decodes baseline
JPEG with `csrc/jpeg_decode.cpp` (g++, ctypes, built on first use by
`_build.load`; where it does not build, decoding raises: there is no
numpy route on the main path), which computes libjpeg-turbo's default
decompression step by step: the islow integer IDCT, fancy upsampling,
the YCbCr tables. So `to_rgb` gives PIL's `convert("RGB")` (grey
replicated) and `to_rgba` cv2's `IMREAD_UNCHANGED` read as the JAX
package turns it into RGBA (alpha 255), byte for byte. EXIF
orientation is ignored, as both reads ignore it.

Read: Huffman-coded sequential DCT (SOF0, SOF1) at 8 bits, 1 or 3
components in one interleaved scan, quantisation tables at 8 and 16
bits, optimised Huffman tables, restart intervals, any integral
sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...).

Refused with NotImplementedError naming the file and the feature:
progressive, lossless, hierarchical and arithmetic-coded JPEG, 12-bit
samples, 2 or 4 components (CMYK, YCCK), RGB three-component files
(Adobe transform 0), one scan a component, DNL. The type is
deliberately not an OSError: the SKU-110K reader replaces an image that
raises OSError with item 0. Corrupt or truncated data raises OSError,
as PIL does; a file that lacks only its EOI marker is one (PIL's read
raises "image file is truncated" on it, and cv2's returns None).

The plain versions the tests hold the C++ against, used by nothing on
the main path: `reconstruct_reference` (vectorised numpy IDCT,
upsampling and colour tables from the quantised coefficients, fast
enough for a photo) and `decode_reference` (a pure-Python entropy
decoder in front of it, for small files only).
"""
from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np

from .. import _build

SIGNATURE = b"\xff\xd8\xff"
_INFO_LEN = 8 + 8 * 4
_MESSAGE_LEN = 512
# zigzag position -> natural (row-major) position in an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


@dataclasses.dataclass
class JPEGImage:
    """A decoded JPEG: `samples` is (H, W, 1) grey or (H, W, 3) RGB
    uint8."""
    samples: np.ndarray


@dataclasses.dataclass
class JPEGCoefficients:
    """The quantised DCT coefficients of a JPEG, before the IDCT.
    `coefficients[i]` is component i's (blocks down, blocks across, 8, 8)
    int16 in natural order, `tables[i]` its (8, 8) quantisation table,
    `sampling[i]` its (h, v) factors; `size` is (height, width)."""
    size: Tuple[int, int]
    coefficients: List[np.ndarray]
    tables: List[np.ndarray]
    sampling: List[Tuple[int, int]]
    sof: int
    restart_interval: int


def _lib() -> ctypes.CDLL:
    lib = _build.load("jpeg_decode")
    lib.jpeg_header.restype = ctypes.c_int32
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_int64]
    for fn in (lib.jpeg_decode, lib.jpeg_coefficients):
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_char_p, ctypes.c_int64]
    return lib


def _raise(status: int, message, name: str) -> None:
    text = f"{name}: {message.value.decode(errors='replace')}"
    if status == 2:
        raise NotImplementedError(text)
    raise OSError(text)


def _header(lib, data: bytes, name: str):
    info = np.zeros(_INFO_LEN, np.int32)
    quant = np.zeros((4, 64), np.uint16)
    message = ctypes.create_string_buffer(_MESSAGE_LEN)
    status = lib.jpeg_header(data, len(data), info.ctypes.data,
                             quant.ctypes.data, message, _MESSAGE_LEN)
    if status:
        _raise(status, message, name)
    return info, quant


def decode_jpeg(data: bytes, name: str = "<bytes>") -> JPEGImage:
    """Decode JPEG bytes with the C++ decoder; `name` goes into every
    error."""
    data = bytes(data)
    lib = _lib()
    info, _ = _header(lib, data, name)
    width, height, ncomp = (int(v) for v in info[:3])
    out = np.empty((height, width, ncomp), np.uint8)
    message = ctypes.create_string_buffer(_MESSAGE_LEN)
    status = lib.jpeg_decode(data, len(data), out.ctypes.data, message,
                             _MESSAGE_LEN)
    if status:
        _raise(status, message, name)
    return JPEGImage(out)


def read_jpeg(path) -> JPEGImage:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))


def decode_coefficients(data: bytes, name: str = "<bytes>"
                        ) -> JPEGCoefficients:
    """The C++ decoder's entropy decode alone: the quantised coefficient
    blocks of each component, with the tables and the sampling."""
    data = bytes(data)
    lib = _lib()
    info, quant = _header(lib, data, name)
    width, height, ncomp = (int(v) for v in info[:3])
    comps = info[8:8 + 8 * ncomp].reshape(ncomp, 8)
    shapes = [(int(c[5]), int(c[4])) for c in comps]
    out = np.zeros(sum(h * w * 64 for h, w in shapes), np.int16)
    message = ctypes.create_string_buffer(_MESSAGE_LEN)
    status = lib.jpeg_coefficients(data, len(data), out.ctypes.data,
                                   message, _MESSAGE_LEN)
    if status:
        _raise(status, message, name)
    coefs, start = [], 0
    for bh, bw in shapes:
        coefs.append(out[start:start + bh * bw * 64].reshape(bh, bw, 8, 8))
        start += bh * bw * 64
    return JPEGCoefficients(
        (height, width), coefs,
        [quant[i].reshape(8, 8).copy() for i in range(ncomp)],
        [(int(c[1]), int(c[2])) for c in comps], int(info[6]),
        int(info[5]))


def to_rgb(img: JPEGImage) -> np.ndarray:
    """(H, W, 3) uint8: PIL's `convert("RGB")` of the image."""
    s = img.samples
    return s if s.shape[2] == 3 else np.repeat(s, 3, axis=-1)


def to_rgba(img: JPEGImage) -> np.ndarray:
    """(H, W, 4) uint8: cv2.imread(IMREAD_UNCHANGED) turned into RGBA as
    the JAX package's `load_image_rgba` does (grey through GRAY2BGRA,
    alpha 255)."""
    rgb = to_rgb(img)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


# ------------------------------------------------------- plain versions

_FIX = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433,
            f0_765366865=6270, f0_899976223=7373, f1_175875602=9633,
            f1_501321110=12299, f1_847759065=15137, f1_961570560=16069,
            f2_053119869=16819, f2_562915447=20995, f3_072711026=25172)


def _idct_1d(x: np.ndarray) -> np.ndarray:
    """jidctint.c's 1-D islow transform along the last axis (int64),
    before its descale."""
    f = _FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["f0_541196100"]
    tmp2 = z1 - z3 * f["f1_847759065"]
    tmp3 = z1 + z2 * f["f0_765366865"]
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z5 = (t0 + t1 + t2 + t3) * f["f1_175875602"]
    z1 = (t0 + t3) * -f["f0_899976223"]
    z2 = (t1 + t2) * -f["f2_562915447"]
    z3 = (t0 + t2) * -f["f1_961570560"] + z5
    z4 = (t1 + t3) * -f["f0_390180644"] + z5
    t0 = t0 * f["f0_298631336"] + z1 + z3
    t1 = t1 * f["f2_053119869"] + z2 + z4
    t2 = t2 * f["f3_072711026"] + z2 + z3
    t3 = t3 * f["f1_501321110"] + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def idct_islow_reference(blocks: np.ndarray, table: np.ndarray
                         ) -> np.ndarray:
    """(N, 8, 8) quantised coefficients -> (N, 8, 8) uint8 samples:
    dequantise, the two islow passes, the range-limit table (value &
    1023 read as a 10-bit signed number, + 128, clamped)."""
    d = blocks.astype(np.int64) * table.astype(np.int64)
    ws = _descale(_idct_1d(d.transpose(0, 2, 1)), 11)
    ws = ws.astype(np.int32).astype(np.int64)  # the int workspace
    out = _descale(_idct_1d(ws.transpose(0, 2, 1)), 18)
    s = ((out & 1023) ^ 512) - 512
    return np.clip(s + 128, 0, 255).astype(np.uint8)


def _plane(coefs: np.ndarray, table: np.ndarray,
           chunk: int = 16384) -> np.ndarray:
    bh, bw = coefs.shape[:2]
    flat = coefs.reshape(-1, 8, 8)
    out = np.empty(flat.shape, np.uint8)
    for s in range(0, len(flat), chunk):
        out[s:s + chunk] = idct_islow_reference(flat[s:s + chunk], table)
    return out.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)


def _upsample(p: np.ndarray, dh: int, dw: int, hr: int, vr: int,
              height: int, width: int) -> np.ndarray:
    """jdsample.c's upsampling of a component plane with
    do_fancy_upsampling on (edge rows and columns replicated)."""
    if hr == vr == 1:
        return p[:height, :width]
    rows = np.arange(height)
    if vr == 2 and (hr == 1 or (hr == 2 and dw > 2)):
        near = rows // 2
        far = np.where(rows % 2, np.minimum(near + 1, dh - 1),
                       np.maximum(near - 1, 0))
        a = p[near, :dw].astype(np.int32)
        b = p[far, :dw].astype(np.int32)
        if hr == 1:
            bias = np.where(rows % 2, 2, 1)[:, None]
            return ((3 * a + b + bias) >> 2)[:, :width].astype(np.uint8)
        cs = 3 * a + b
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out = np.stack([(3 * cs + left + 8) >> 4,
                        (3 * cs + right + 7) >> 4], -1)
        return out.reshape(height, 2 * dw)[:, :width].astype(np.uint8)
    if hr == 2 and vr == 1 and dw > 2:
        c = p[:height, :dw].astype(np.int32)
        left = np.concatenate([c[:, :1], c[:, :-1]], 1)
        right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
        out = np.stack([(3 * c + left + 1) >> 2, (3 * c + right + 2) >> 2],
                       -1)
        return out.reshape(height, 2 * dw)[:, :width].astype(np.uint8)
    return p[rows // vr][:, np.arange(width) // hr]


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((91881 * x + half) >> 16, (116130 * x + half) >> 16,
            -46802 * x, -22554 * x + half)


def reconstruct_reference(coefficients: Sequence[np.ndarray],
                          tables: Sequence[np.ndarray],
                          sampling: Sequence[Tuple[int, int]],
                          size: Tuple[int, int]) -> np.ndarray:
    """Plain numpy version of the C++ decoder's pixel stage: quantised
    coefficient blocks (one (bh, bw, 8, 8) array a component), their
    quantisation tables and (h, v) sampling, and the image's (height,
    width) -> (H, W, 1) grey or (H, W, 3) RGB uint8."""
    height, width = size
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    planes = []
    for coefs, table, (h, v) in zip(coefficients, tables, sampling):
        p = _plane(np.asarray(coefs), np.asarray(table))
        if len(coefficients) == 1:
            return p[:height, :width, None].copy()
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        planes.append(_upsample(p, dh, dw, hmax // h, vmax // v, height,
                                width).astype(np.int64))
    y, cb, cr = planes
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


class _Bits:
    """MSB-first bits of one restart segment (stuffing removed); zeros
    past the end, as a decoder fed by a marker sees."""

    def __init__(self, data: bytes):
        self.value = int.from_bytes(data, "big") if data else 0
        self.length = len(data) * 8
        self.pos = 0

    def get(self, n: int) -> int:
        if self.pos + n > self.length:
            raise OSError("entropy-coded segment ends inside a block")
        shift = self.length - self.pos - n
        self.pos += n
        return (self.value >> shift) & ((1 << n) - 1)


def _huffman_codes(counts: bytes, symbols: bytes) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[(length, code)] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return codes


def _decode_symbol(bits: _Bits, codes: dict) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | bits.get(1)
        if (length, code) in codes:
            return codes[(length, code)]
    raise OSError("bad Huffman code")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _scan_segments(data: bytes, start: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from `start` cut at its RST markers, with
    0xFF 0x00 turned into 0xFF; and the offset of the marker that ends
    the scan."""
    segments, cur, i = [], bytearray(), start
    while True:
        if data[i] != 0xFF:
            cur.append(data[i])
            i += 1
            continue
        j = i + 1
        while data[j] == 0xFF:
            j += 1
        if data[j] == 0:
            cur.append(0xFF)
            i = j + 1
        elif 0xD0 <= data[j] <= 0xD7:
            segments.append(bytes(cur))
            cur, i = bytearray(), j + 1
        else:
            segments.append(bytes(cur))
            return segments, i


def decode_reference(data: bytes) -> np.ndarray:
    """Plain Python decode of a baseline JPEG (small files only): the
    markers, a bit-by-bit Huffman decode, then `reconstruct_reference`.
    Returns what `decode_jpeg(data).samples` does."""
    coefs = decode_coefficients_reference(data)
    return reconstruct_reference(coefs.coefficients, coefs.tables,
                                 coefs.sampling, coefs.size)


def decode_coefficients_reference(data: bytes) -> JPEGCoefficients:
    """Plain Python version of `decode_coefficients`."""
    if not data.startswith(b"\xff\xd8"):
        raise OSError("not a JPEG file")
    quant, dc_tables, ac_tables = {}, {}, {}
    restart, frame, sof = 0, None, 0
    pos = 2
    while True:
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in (0xC0, 0xC1):
            sof = marker
            precision, height, width, n = struct.unpack(">BHHB", body[:6])
            frame = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                      body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(n)]
        elif 0xC1 < marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(f"SOF marker {marker:#x}")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 2 if pq else 1
                vals = [int.from_bytes(body[i + 1 + size * k:
                                            i + 1 + size * (k + 1)], "big")
                        for k in range(64)]
                table = np.zeros(64, np.uint16)
                table[ZIGZAG] = vals
                quant[tq] = table.reshape(8, 8)
                i += 1 + 64 * size
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                index, counts = body[i], body[i + 1:i + 17]
                symbols = body[i + 17:i + 17 + sum(counts)]
                (ac_tables if index & 0x10 else dc_tables)[index & 3] = \
                    _huffman_codes(counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body)
        elif marker == 0xDA:
            break
    n = body[0]
    ids = [c[0] for c in frame]
    order = [ids.index(body[1 + 2 * i]) for i in range(n)]
    tables = {ids.index(body[1 + 2 * i]): (body[2 + 2 * i] >> 4,
                                           body[2 + 2 * i] & 15)
              for i in range(n)}
    hmax = max(c[1] for c in frame)
    vmax = max(c[2] for c in frame)
    if len(frame) == 1:
        dims = [(-(-height // 8), -(-width // 8))]
        mcus, units = dims[0][0] * dims[0][1], [(1, 1)]
    else:
        my, mx = -(-height // (8 * vmax)), -(-width // (8 * hmax))
        dims = [(my * c[2], mx * c[1]) for c in frame]
        mcus, units = my * mx, [(c[1], c[2]) for c in frame]
    per_row = dims[0][1] if len(frame) == 1 else mx
    blocks = [np.zeros((bh, bw, 64), np.int64) for bh, bw in dims]
    segments, _ = _scan_segments(data, pos)
    per_segment = restart or mcus
    for m in range(mcus):
        if m % per_segment == 0:
            bits = _Bits(segments[m // per_segment])
            pred = [0] * len(frame)
        row, col = divmod(m, per_row)
        for ci in order:
            h, v = units[ci]
            dc, ac = dc_tables[tables[ci][0]], ac_tables[tables[ci][1]]
            for by in range(v):
                for bx in range(h):
                    blk = blocks[ci][row * v + by, col * h + bx]
                    s = _decode_symbol(bits, dc)
                    pred[ci] += _extend(bits.get(s), s) if s else 0
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        rs = _decode_symbol(bits, ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[ZIGZAG[k]] = _extend(bits.get(s), s)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
    return JPEGCoefficients(
        (height, width),
        [b.astype(np.int16).reshape(b.shape[0], b.shape[1], 8, 8)
         for b in blocks],
        [quant[c[3]] for c in frame], [(c[1], c[2]) for c in frame], sof,
        restart)
