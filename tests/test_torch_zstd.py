"""The port's zstd decoder (cvpce_tpu_torch/utils/zstd.py,
csrc/zstd_decode.cpp) against the `zstandard` module, byte for byte:
levels -5, 1, 3 and 19, with and without the checksum and the content
size, 1 B to a few MB (several blocks), incompressible data (raw blocks),
runs (RLE blocks), streamed frames (no content size), a long window,
frames back to back with a skippable frame between; the committed frames
of tests/torch_fixtures/ (the ones chip_smoke.py decodes on the card).
A flipped byte or a truncated frame raises OSError, a dictionary frame
NotImplementedError naming its ID.

Inputs are seeded numpy draws; outputs are compared exactly."""
import json
import os
import struct

import numpy as np
import pytest
import zstandard

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.utils import zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (-5, 1, 3, 19)
FLAGS = [(c, s) for c in (False, True) for s in (False, True)]


def _data(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng((abs(seed), n, len(kind)))
    if kind == "noise":
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == "run":
        return bytes([int(rng.integers(0, 256))]) * n
    if kind == "floats":  # quantised: literals and matches both
        return (np.round(rng.standard_normal(n // 4 + 1) * 8) / 8).astype(
            np.float32).tobytes()[:n]
    words = np.array([b"alpha ", b"beta ", b"gamma ", b"shelf ", b"gap ",
                      b"product "], object)
    return b"".join(words[rng.integers(0, len(words), n // 4 + 1)])[:n]


def _compress(data: bytes, level: int, checksum: bool = True,
              size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=size).compress(data)


@pytest.mark.parametrize("checksum,size", FLAGS)
@pytest.mark.parametrize("level", LEVELS)
def test_frames_equal_zstandard(level, checksum, size):
    """Every data kind at 1 B to 300 KB (three blocks); the decoder gives
    zstandard's input back, with and without the size it expects."""
    sizes = (1, 2, 17, 1000, 70000, 300000)
    for kind in ("noise", "run", "floats", "text"):
        for n in sizes:
            data = _data(kind, n, level)
            frame = _compress(data, level, checksum, size)
            assert zstd.decompress(frame) == data, (kind, n)
            assert zstd.decompress(frame, size=n) == data, (kind, n)


@pytest.mark.parametrize("level", LEVELS)
def test_several_megabytes(level):
    """3 MB of quantised floats and text: 24 blocks, every FSE table mode
    and both Huffman stream counts over them."""
    n = 3 << 20 if level < 19 else 1 << 20
    for kind in ("floats", "text"):
        data = _data(kind, n, 7)
        assert zstd.decompress(_compress(data, level)) == data, kind


def test_streamed_frames_and_back_to_back():
    """Frames that zstandard streams (no content size, blocks as they
    come), two frames with a skippable frame between, and a 2**27 window
    with long-distance matching."""
    a, b = _data("floats", 400000, 1), _data("text", 50000, 2)
    stream = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = stream.compress(a) + stream.compress(b) + stream.flush()
    assert zstd.decompress(streamed) == a + b
    skippable = struct.pack("<II", 0x184D2A5E, 9) + b"ignore me"
    joined = _compress(a, 1) + skippable + _compress(b, 19, size=False)
    assert zstd.decompress(joined) == a + b
    assert zstd.decompress(joined, size=len(a) + len(b)) == a + b
    assert zstd.decompress(_compress(b"", 3)) == b""
    params = zstandard.ZstdCompressionParameters.from_level(
        19, window_log=27, enable_ldm=True)
    data = _data("floats", 1 << 20, 3) * 3
    frame = zstandard.ZstdCompressor(
        compression_params=params).compress(data)
    assert zstd.decompress(frame) == data


def test_committed_frames():
    """The frames chip_smoke.py decodes on the card, against the seeded
    data they were written from (scripts/write_orbax_fixture.py)."""
    with open(os.path.join(REPO, testing.ZSTD_FRAMES + ".bin"), "rb") as f:
        blob = f.read()
    with open(os.path.join(REPO, testing.ZSTD_FRAMES + ".json")) as f:
        index = json.load(f)
    assert len(index) == 12
    for entry in index:
        frame = blob[entry["offset"]:entry["offset"] + entry["length"]]
        want = b"".join(testing.zstd_fixture_data(k)
                        for k in entry["parts"])
        assert zstd.decompress(frame) == want, entry["name"]
        assert zstandard.ZstdDecompressor().decompressobj().decompress(
            frame) == testing.zstd_fixture_data(entry["parts"][0]), \
            entry["name"]


def test_corrupt_and_truncated_frames_raise():
    """Each flipped byte of a checksummed frame raises OSError (the
    checksum or the structure catches it), as does every truncation, an
    output of another size than expected, trailing garbage and no
    input."""
    data = _data("floats", 200000, 5) + _data("text", 50000, 5)
    frame = _compress(data, 3)
    step = max(1, len(frame) // 400)
    for i in range(0, len(frame), step):
        bad = bytearray(frame)
        bad[i] ^= 1 << (i % 8)
        with pytest.raises(OSError):
            zstd.decompress(bytes(bad))
    for cut in (1, 4, 5, 6, 9, len(frame) // 3, len(frame) - 4,
                len(frame) - 1):
        with pytest.raises(OSError):
            zstd.decompress(frame[:cut])
    with pytest.raises(OSError, match="expected"):
        zstd.decompress(frame, size=len(data) - 1)
    with pytest.raises(OSError, match="expected"):
        zstd.decompress(frame, size=len(data) + 1)
    with pytest.raises(OSError, match="not a zstd frame"):
        zstd.decompress(frame + b"garbage!")
    with pytest.raises(OSError, match="truncated"):
        zstd.decompress(b"")


def test_dictionary_frames_raise_naming_the_id():
    rng = np.random.default_rng(11)
    samples = [bytes(rng.integers(0, 24, 300).astype(np.uint8))
               for _ in range(300)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[0])
    with pytest.raises(NotImplementedError,
                       match=f"dictionary {dictionary.dict_id()}"):
        zstd.decompress(frame)


def test_xxh64_known_values():
    """XXH64 with seed 0 (the frame checksum keeps its low 32 bits), at
    the published values for "" and "abc", and 32 bytes and more through
    the four-lane loop."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    data = _data("text", 1000, 3)
    frame = _compress(data, 3)
    assert struct.unpack("<I", frame[-4:])[0] == zstd.xxh64(data) \
        & 0xFFFFFFFF
