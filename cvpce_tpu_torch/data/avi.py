"""RIFF AVI reader of the port, for GroZi-120's Motion-JPEG shelf videos.

The JAX package reads `video/Shelf_{v}.avi` with `cv2.VideoCapture`,
and the card's machine has no cv2 and no video library. This module
walks the RIFF structure in Python: the `hdrl` list (`avih`, then the
`strh` / `strf` of the first video stream), the video stream's `##dc` /
`##db` chunks of the `movi` list in file order (inside `rec ` lists
too), the `movi` lists of OpenDML `RIFF AVIX` extensions after it, and
`idx1` where present, whose video entries must point at those chunks.
Frame f is the f-th chunk, the frame that the f-th `cap.read()` of
cv2's default (FFmpeg) backend returns, as the JAX package reads them:
a chunk of no bytes is no frame, and a file without idx1 or with AVIX
extensions reads whole. A chunk cut off by the end of the file ends
the video.

Each frame is a JPEG image, decoded by the port's decoder
(`data/jpeg.py`, libjpeg-turbo's arithmetic: cv2's `CAP_OPENCV_MJPEG`
backend reads through libjpeg and gives the same pixels; its default
FFmpeg backend decodes with FFmpeg's own IDCT and chroma filter: on
smooth frames about 2 levels apart on average, some tens at the partial
blocks of an odd-sized frame). A frame without Huffman
tables takes the standard ones, as Motion-JPEG frames omit them.

The video's fourcc (`strf`'s biCompression) must name Motion-JPEG:
`MJPG`, `AVI1`, `mjpa` or `jpeg`, in any case. Any other raises
NotImplementedError naming the file and the fourcc (not an OSError,
which the SKU-110K reader turns into item 0); so does an `AVI1` frame
that holds two interlaced fields. A file that is not a RIFF AVI, or
whose `idx1` disagrees with its chunks, raises OSError.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from . import jpeg

MJPEG_FOURCCS = ("MJPG", "AVI1", "MJPA", "JPEG")


@dataclasses.dataclass
class AVIVideo:
    """A Motion-JPEG AVI: its video stream's `fourcc`, frame `width`
    and `height`, and the (file offset, size) of each frame's chunk
    data, in frame order."""
    path: str
    fourcc: str
    width: int
    height: int
    chunks: List[Tuple[int, int]]

    def __len__(self) -> int:
        return len(self.chunks)

    def frame_bytes(self, i: int) -> bytes:
        offset, size = self.chunks[i]
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(size)

    def frame(self, i: int, data: Optional[bytes] = None) -> np.ndarray:
        """Frame i as (H, W, 3) RGB uint8 (`data`: its bytes, if read)."""
        data = self.frame_bytes(i) if data is None else data
        return jpeg.to_rgb(jpeg.decode_jpeg(data, f"{self.path} frame {i}"))

    def frames(self) -> Iterator[np.ndarray]:
        with open(self.path, "rb") as f:
            for i, (offset, size) in enumerate(self.chunks):
                f.seek(offset)
                yield self.frame(i, f.read(size))


def _header(f: BinaryIO, end: int) -> Optional[Tuple[bytes, int, int]]:
    """(id, size, data offset) of the chunk at the file position, or
    None where no whole header fits before `end`."""
    at = f.tell()
    if at + 8 > end:
        return None
    head = f.read(8)
    if len(head) < 8:
        return None
    cid, size = struct.unpack("<4sI", head)
    return cid, size, at + 8


def _skip(f: BinaryIO, offset: int, size: int) -> None:
    f.seek(offset + size + (size & 1))


def _read_hdrl(f: BinaryIO, end: int, path: str):
    """(stream number, fourcc, width, height) of the first video
    stream; the width and height from its strf, else avih."""
    avih_wh, stream = None, 0
    while (h := _header(f, end)) is not None:
        cid, size, at = h
        if cid == b"avih" and size >= 40:
            vals = struct.unpack("<10I", f.read(40))
            avih_wh = vals[8], vals[9]
        elif cid == b"LIST" and f.read(4) == b"strl":
            strh = strf = None
            while (s := _header(f, at + size)) is not None:
                sid, ssize, sat = s
                if sid == b"strh" and ssize >= 32:
                    strh = f.read(ssize)
                elif sid == b"strf":
                    strf = f.read(ssize)
                _skip(f, sat, ssize)
            if strh is not None and strh[:4] == b"vids":
                if strf is None or len(strf) < 20:
                    raise OSError(f"{path}: video stream without a "
                                  "BITMAPINFOHEADER")
                width, height = struct.unpack("<ii", strf[4:12])
                if (width, height) == (0, 0) and avih_wh:
                    width, height = avih_wh
                return (stream, strf[16:20].decode("latin-1"), width,
                        abs(height))
            stream += 1
        _skip(f, at, size)
    raise OSError(f"{path}: AVI without a video stream")


def _walk_movi(f: BinaryIO, end: int, ids: Tuple[bytes, bytes],
               out: List[Tuple[int, int]], file_size: int,
               positions: Optional[dict] = None) -> bool:
    """Appends the (offset, size) of the chunks named `ids` between the
    file position and `end`, descending into `rec ` lists; `positions`
    maps each such chunk's header offset to its index in `out`. False
    where a chunk runs past the end of the file."""
    while (h := _header(f, end)) is not None:
        cid, size, at = h
        if cid == b"LIST":
            if f.read(4) == b"rec " and not _walk_movi(
                    f, at + size, ids, out, file_size, positions):
                return False
        elif cid in ids:
            if at + size > file_size:
                return False
            if size:
                if positions is not None:
                    positions[at - 8] = len(out)
                out.append((at, size))
        _skip(f, at, size)
    return True


def _check_idx1(f: BinaryIO, size: int, ids: Tuple[bytes, bytes],
                movi_at: int, positions: dict, n: int, path: str) -> None:
    """The video entries of idx1 (offsets from the `movi` fourcc, or
    from the start of the file) name the first `n` chunks in order."""
    raw = f.read(size - size % 16)
    entries = [e for e in struct.iter_unpack("<4sIII", raw)
               if e[0] in ids and e[3]]
    if not entries:
        return
    base = movi_at if movi_at + entries[0][2] in positions else 0
    got = [positions.get(base + e[2]) for e in entries]
    if got != list(range(len(entries))) or len(entries) != n:
        raise OSError(f"{path}: the idx1 index does not match the movi "
                      "list's video chunks")


def open_avi(path) -> AVIVideo:
    """Parses `path`; raises as the module docstring says."""
    path = str(path)
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:] != b"AVI ":
            raise OSError(f"{path}: not a RIFF AVI file")
        (riff_size,) = struct.unpack("<I", head[4:8])
        end = min(8 + riff_size, file_size)
        video = None
        chunks: List[Tuple[int, int]] = []
        positions: dict = {}
        idx1, movi_at, whole = None, None, True
        while (h := _header(f, end)) is not None:
            cid, size, at = h
            if cid == b"LIST":
                form = f.read(4)
                if form == b"hdrl":
                    video = _read_hdrl(f, min(at + size, end), path)
                elif form == b"movi" and video is not None and whole:
                    movi_at = at
                    ids = _chunk_ids(video[0])
                    whole = _walk_movi(f, min(at + size, end), ids, chunks,
                                       file_size, positions)
            elif cid == b"idx1":
                idx1 = (at, size)
            _skip(f, at, size)
        if video is None:
            raise OSError(f"{path}: AVI without an hdrl list")
        stream, fourcc, width, height = video
        if fourcc.upper() not in MJPEG_FOURCCS:
            raise NotImplementedError(
                f"{path}: AVI video of fourcc {fourcc!r}; the port reads "
                f"Motion-JPEG ({', '.join(MJPEG_FOURCCS)}) only")
        ids = _chunk_ids(stream)
        if idx1 is not None and whole and movi_at is not None:
            f.seek(idx1[0])
            _check_idx1(f, idx1[1], ids, movi_at, positions, len(chunks),
                        path)
        # OpenDML: RIFF AVIX extensions, each with a movi list
        f.seek(end + (end & 1))
        while whole and (h := _header(f, file_size)) is not None:
            cid, size, at = h
            if cid != b"RIFF" or f.read(4) != b"AVIX":
                break
            stop = min(at + size, file_size)
            while whole and (m := _header(f, stop)) is not None:
                mid, msize, mat = m
                if mid == b"LIST" and f.read(4) == b"movi":
                    whole = _walk_movi(f, min(mat + msize, stop), ids,
                                       chunks, file_size)
                _skip(f, mat, msize)
            f.seek(at + size + (size & 1))
    return AVIVideo(path, fourcc, width, height, chunks)


def _chunk_ids(stream: int) -> Tuple[bytes, bytes]:
    return (f"{stream:02d}dc".encode(), f"{stream:02d}db".encode())
