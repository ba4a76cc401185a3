"""The port's RIFF AVI reader (cvpce_tpu_torch/data/avi.py) against
cv2.VideoCapture, which the JAX package reads GroZi-120's videos with.

Files: Motion-JPEG AVIs that cv2.VideoWriter writes (its FFmpeg and its
own MJPEG writer) of seeded smooth frames at 160x120 and (its MJPEG
writer) at an odd 75x53, and files of `testing.write_avi` holding the
port's encoder's frames with their Huffman tables dropped (as
Motion-JPEG stores them), with and without idx1, with an OpenDML RIFF
AVIX extension, with an empty chunk. The frames equal cv2's libjpeg
backend's (CAP_OPENCV_MJPEG) bit for bit. cv2's default FFmpeg backend
decodes with FFmpeg's IDCT and chroma filter: its frames lie within
FFMPEG_MAX of the port's in every channel value and within FFMPEG_MEAN
on average (measured on these seeds: at most 37 and 3.35 at 75x53, 13
and 1.88 at 160x120, 12 and 2.44 at 64x48; the largest at the odd
frames' partial last blocks). The frame count and order are the FFmpeg
backend's, which the JAX package uses: it reads a file without idx1 and
the AVIX extension, which the libjpeg backend does not, and skips an
empty chunk, which the libjpeg backend counts as a frame. Another
fourcc, or an interlaced AVI1 frame, raises NotImplementedError naming
the file."""
import cv2
import numpy as np
import pytest

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.data import avi, jpeg

FFMPEG_MAX = 40
FFMPEG_MEAN = 4.0
FRAMES = 5


def cv2_frames(path, api):
    cap = cv2.VideoCapture(str(path), api)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return out
        out.append(frame[..., ::-1])


def assert_near_ffmpeg(port, path):
    ff = cv2_frames(path, cv2.CAP_FFMPEG)
    assert len(ff) == len(port)
    for a, b in zip(port, ff):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= FFMPEG_MAX and d.mean() <= FFMPEG_MEAN, \
            (d.max(), d.mean())


def encoded(rng, h, w, n=FRAMES):
    frames = testing.smooth_frames(rng, n, h, w)
    return frames, [jpeg.encode_jpeg(f) for f in frames]


@pytest.mark.parametrize("writer,hw", [
    ("ffmpeg", (120, 160)), ("opencv", (120, 160)), ("opencv", (53, 75))])
def test_cv2_writers_files_read_as_cv2_reads_them(tmp_path, writer, hw):
    """cv2's FFmpeg writer crops an odd size to an even one, so the odd
    size is its own MJPEG writer's alone."""
    h, w = hw
    frames = testing.smooth_frames(np.random.default_rng(41), FRAMES, h, w)
    path = tmp_path / "v.avi"
    api = cv2.CAP_FFMPEG if writer == "ffmpeg" else cv2.CAP_OPENCV_MJPEG
    out = cv2.VideoWriter(str(path), api, cv2.VideoWriter_fourcc(*"MJPG"),
                          10, (w, h))
    for f in frames:
        out.write(np.ascontiguousarray(f[..., ::-1]))
    out.release()
    video = avi.open_avi(path)
    assert (video.fourcc, video.width, video.height, len(video)) == \
        ("MJPG", w, h, FRAMES)
    port = list(video.frames())
    libjpeg = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    assert len(libjpeg) == FRAMES
    for i, (a, b) in enumerate(zip(port, libjpeg)):
        np.testing.assert_array_equal(a, b, err_msg=str(i))
        np.testing.assert_array_equal(video.frame(i), a)
    assert_near_ffmpeg(port, path)


@pytest.mark.parametrize("hw", ((120, 160), (53, 75)))
def test_frames_without_huffman_tables(tmp_path, hw):
    """The port's JPEGs as Motion-JPEG frames (AVI1 APP0, no DHT): both
    cv2 backends read them, and the port's frames are its decode of the
    JPEG with its tables, the libjpeg backend's frames bit for bit."""
    h, w = hw
    _, enc = encoded(np.random.default_rng(42), h, w)
    frames = [testing.mjpeg_frame(e) for e in enc]
    assert all(b"\xff\xc4" not in f[:f.index(b"\xff\xda")] for f in frames)
    path = tmp_path / "v.avi"
    testing.write_avi(path, frames, w, h)
    port = list(avi.open_avi(path).frames())
    libjpeg = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    assert len(port) == len(libjpeg) == FRAMES
    for a, b, e in zip(port, libjpeg, enc):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, jpeg.decode_jpeg(e).samples)
    assert_near_ffmpeg(port, path)


def test_frame_order_follows_the_ffmpeg_backend(tmp_path):
    """No idx1, an AVIX extension, an empty chunk: the port's frames are
    the FFmpeg backend's, in its order."""
    _, enc = encoded(np.random.default_rng(43), 48, 64, 6)
    frames = [testing.mjpeg_frame(e) for e in enc]
    want = [jpeg.decode_jpeg(e).samples for e in enc]
    cases = {"no_index": dict(index=False), "avix": dict(avix_from=4),
             "empty": dict(frames=frames[:2] + [b""] + frames[2:])}
    for name, kw in cases.items():
        path = tmp_path / f"{name}.avi"
        testing.write_avi(path, kw.pop("frames", frames), 64, 48, **kw)
        port = list(avi.open_avi(path).frames())
        assert len(port) == 6, name
        for a, b in zip(port, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert_near_ffmpeg(port, path)
    # the libjpeg backend stops at the first RIFF and counts the empty
    # chunk as a frame
    assert len(cv2_frames(tmp_path / "avix.avi", cv2.CAP_OPENCV_MJPEG)) == 4
    assert len(cv2_frames(tmp_path / "empty.avi",
                          cv2.CAP_OPENCV_MJPEG)) == 7


def test_fourccs(tmp_path):
    """The Motion-JPEG fourccs read in any case; another one raises
    NotImplementedError naming the file and the fourcc, not OSError."""
    _, enc = encoded(np.random.default_rng(44), 16, 24, 2)
    frames = [testing.mjpeg_frame(e) for e in enc]
    for fourcc in (b"AVI1", b"mjpa", b"jpeg", b"mjpg"):
        path = tmp_path / f"{fourcc.decode()}.avi"
        testing.write_avi(path, frames, 24, 16, fourcc=fourcc)
        video = avi.open_avi(path)
        assert video.fourcc == fourcc.decode() and len(video) == 2
    for fourcc in (b"XVID", b"H264", b"\0\0\0\0"):
        other = tmp_path / "other.avi"
        testing.write_avi(other, frames, 24, 16, fourcc=fourcc)
        with pytest.raises(NotImplementedError) as err:
            avi.open_avi(other)
        assert str(other) in str(err.value)
        assert repr(fourcc.decode("latin-1")) in str(err.value)
        assert not isinstance(err.value, OSError)


def test_interlaced_and_broken_files(tmp_path):
    _, enc = encoded(np.random.default_rng(45), 16, 24, 2)
    path = tmp_path / "fields.avi"
    testing.write_avi(path, [testing.mjpeg_frame(e, polarity=1)
                             for e in enc], 24, 16)
    video = avi.open_avi(path)
    with pytest.raises(NotImplementedError, match="interlaced") as err:
        video.frame(1)
    assert f"{path} frame 1" in str(err.value)
    not_avi = tmp_path / "x.avi"
    not_avi.write_bytes(b"RIFF\4\0\0\0WAVE")
    with pytest.raises(OSError, match="not a RIFF AVI"):
        avi.open_avi(not_avi)
    good = tmp_path / "good.avi"
    testing.write_avi(good, [testing.mjpeg_frame(e) for e in enc], 24, 16)
    data = good.read_bytes()
    at = data.index(b"idx1") + 8 + 8  # the first entry's offset
    bad = tmp_path / "bad_index.avi"
    bad.write_bytes(data[:at] + b"\xff\xff\0\0" + data[at + 4:])
    with pytest.raises(OSError, match="idx1"):
        avi.open_avi(bad)
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:data.index(b"idx1") - 40])
    assert len(avi.open_avi(cut)) == 1
