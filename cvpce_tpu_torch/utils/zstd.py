"""Zstandard decoder and raw-block encoder of the port: the card's
machine has no zstd library.

The JAX package's orbax checkpoints store every manifest, b-tree node
and zarr chunk as a zstd frame, which orbax reads through tensorstore.
The port decodes them with `csrc/zstd_decode.cpp` (g++, ctypes, built
on first use by `_build.load`; where it does not build, decoding raises:
there is no Python route). It reads RFC 8878 frames: raw, RLE and
compressed blocks; raw, RLE, Huffman-coded (one or four streams) and
treeless literals; predefined, RLE, compressed and repeated FSE tables;
repeat offsets; any window size; the optional content size and
checksum (XXH64, verified where the frame carries one); skippable
frames; frames placed back to back.

A frame that needs a dictionary raises NotImplementedError naming the
dictionary ID. Corrupt or truncated input raises OSError: the decoder
never returns short output.

`compress` writes the frames of the port's orbax writer
(utils/orbax_write.py): one frame of Raw blocks (Block_Type 0, at most
128 KiB each) with its Frame_Content_Size and content checksum, which
libzstd, tensorstore and this decoder read. It has no entropy coder, so
an export comes out about as large as its raw arrays: gln_r5's 325
arrays hold 130.9 MB, the port's rewrite of it takes 131.1 MB on disk,
where the JAX package's orbax (zstd level 1) wrote 120.7 MB.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from .. import _build

_MESSAGE_LEN = 512
MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
# Frame_Header_Descriptor: Content_Checksum_flag, no single segment, no
# dictionary; the FCS_Field_Size flag goes in bits 6-7
_CHECKSUM_FLAG = 0x04
# Window_Descriptor of a 128 KiB window (Exponent 7, Mantissa 0), the
# Block_Maximum_Size of every block
_WINDOW_128K = 7 << 3


def _lib() -> ctypes.CDLL:
    lib = _build.load("zstd_decode")
    lib.zstd_decode_into.restype = ctypes.c_int32
    lib.zstd_decode_into.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int64]
    lib.zstd_decode.restype = ctypes.c_void_p
    lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_char_p, ctypes.c_int64]
    lib.zstd_take.restype = None
    lib.zstd_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.zstd_xxh64.restype = ctypes.c_uint64
    lib.zstd_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    return lib


def _raise(status: int, message, name: str) -> None:
    text = f"{name}: {message.value.decode(errors='replace')}"
    if status == 2:
        raise NotImplementedError(text)
    raise OSError(text)


def decompress_into(buf, out: np.ndarray, name: str = "<bytes>") -> None:
    """Decode every frame of `buf` into the C-contiguous array `out`,
    whose byte size the frames must fill exactly."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decompress_into needs a writeable C-contiguous "
                         "array")
    data = bytes(buf)
    message = ctypes.create_string_buffer(_MESSAGE_LEN)
    status = _lib().zstd_decode_into(data, len(data), out.ctypes.data,
                                     out.nbytes, message, _MESSAGE_LEN)
    if status:
        _raise(status, message, name)


def decompress(buf, size: Optional[int] = None,
               name: str = "<bytes>") -> bytes:
    """The bytes that the zstd frames of `buf` decode to. Where the
    caller knows the output's `size`, output of another size raises
    OSError; `name` goes into every error."""
    if size is not None:
        out = np.empty(int(size), np.uint8)
        decompress_into(buf, out, name)
        return out.tobytes()
    data = bytes(buf)
    lib = _lib()
    n = ctypes.c_int64(0)
    status = ctypes.c_int32(0)
    message = ctypes.create_string_buffer(_MESSAGE_LEN)
    handle = lib.zstd_decode(data, len(data), ctypes.byref(n),
                             ctypes.byref(status), message, _MESSAGE_LEN)
    if not handle:
        _raise(status.value, message, name)
    out = ctypes.create_string_buffer(max(n.value, 1))
    lib.zstd_take(handle, out)
    return out.raw[:n.value]


def xxh64(buf) -> int:
    """XXH64 of `buf` with seed 0, as a frame's checksum uses it (its low
    32 bits)."""
    data = bytes(buf)
    return int(_lib().zstd_xxh64(data, len(data)))


def _content_size_field(n: int) -> bytes:
    """(FCS_Field_Size flag << 6) as a byte, then the field: 2 bytes
    (n - 256) where they fit, else 4 or 8."""
    if 256 <= n < 256 + (1 << 16):
        return bytes([1 << 6]) + struct.pack("<H", n - 256)
    if n < 1 << 32:
        return bytes([2 << 6]) + struct.pack("<I", n)
    return bytes([3 << 6]) + struct.pack("<Q", n)


def compress(data) -> bytes:
    """One zstd frame of Raw blocks holding `data`, with its content size
    and checksum."""
    view = memoryview(data).cast("B")
    n = len(view)
    fcs = _content_size_field(n)
    parts = [struct.pack("<I", MAGIC),
             bytes([fcs[0] | _CHECKSUM_FLAG, _WINDOW_128K]), fcs[1:]]
    for start in range(0, max(n, 1), BLOCK_MAX):
        size = min(BLOCK_MAX, n - start)
        last = start + size == n
        parts.append((last | size << 3).to_bytes(3, "little"))
        parts.append(view[start:start + size])
    parts.append(struct.pack("<I", xxh64(view) & 0xFFFFFFFF))
    return b"".join(parts)
