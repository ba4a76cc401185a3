"""Zstandard decoder of the port: the card's machine has no zstd library.

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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import _build

_MESSAGE_LEN = 512


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
