"""GroZi-120's test frames out of its videos: the port's
`extract_grozi_test_imgs` (data/grozi.py over data/avi.py and
jpeg.save_jpeg) and `cvpce-torch datasets grozi extract-test-images`
against the JAX package's `extract_grozi_test_imgs` (cv2.VideoCapture's
default FFmpeg backend, cv2.imwrite) on copies of one small layout: two
Motion-JPEG videos of seeded smooth 160x120 frames (the port's encoder,
no DHT), frames of interest on both, one past the first video's end.

Equal: the files written, index.txt, the missing-frame line, and
GroZiTestSet's annotations and boxes read by both packages. Each file
the port writes is what cv2.imwrite writes of the frame cv2's libjpeg
backend decodes, byte for byte. The JAX package's frames come from
FFmpeg's decoder: the two packages' extracted images lie within
PIXEL_MAX of each other in every channel value and PIXEL_MEAN on
average (measured 6 and 1.00: FFmpeg's decode against libjpeg's, as
tests/test_torch_avi.py bounds it, then both re-encoded at quality
95)."""
import contextlib
import io
import os
import shutil

import cv2
import numpy as np

from cvpce_tpu.data import grozi as j_grozi
from cvpce_tpu.data import transforms as j_T
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.cli import main as cli_main
from cvpce_tpu_torch.data import grozi, jpeg
from cvpce_tpu_torch.data import transforms as T

PIXEL_MAX = 12
PIXEL_MEAN = 2.0
INTEREST = {1: [2, 5, 9, 12], 2: [0, 3, 6]}  # video 1 has 10 frames


def layout(root):
    rng = np.random.default_rng(51)
    videos = {1: testing.smooth_frames(rng, 10, 120, 160),
              2: testing.smooth_frames(rng, 7, 120, 160)}
    return testing.write_grozi_videos(str(root), videos, INTEREST, rng)


def _run(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_extraction_matches_jax(tmp_path):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    encoded = layout(jroot)
    shutil.copytree(jroot, proot)
    said = _run(j_grozi.extract_grozi_test_imgs, str(jroot))
    assert _run(grozi.extract_grozi_test_imgs, str(proot)) == said
    assert said == ("Not all frames extracted from video 1: "
                    "missing [12]...\n")
    names = sorted(os.listdir(jroot / "extracted"))
    assert sorted(os.listdir(proot / "extracted")) == names
    index = (proot / "extracted" / "index.txt").read_text()
    assert index == (jroot / "extracted" / "index.txt").read_text()
    assert sorted(index.split()) == ["1_2.jpg", "1_5.jpg", "1_9.jpg",
                                     "2_0.jpg", "2_3.jpg", "2_6.jpg"]
    want, got = j_grozi.GroZiTestSet(str(jroot)), \
        grozi.GroZiTestSet(str(proot))
    assert len(got.index) == len(want.index) == 6
    for g, w in zip(got.index, want.index):
        assert os.path.basename(g["path"]) == os.path.basename(w["path"])
        np.testing.assert_array_equal(g["anns"], w["anns"])
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        assert g["anns"].dtype == w["anns"].dtype
        assert g["boxes"].dtype == w["boxes"].dtype
    for name in index.split():
        v, f = (int(s) for s in name[:-4].split("_"))
        frame = jpeg.decode_jpeg(encoded[v][f]).samples
        assert (proot / "extracted" / name).read_bytes() == cv2.imencode(
            ".jpg", frame[..., ::-1])[1].tobytes(), name
        d = np.abs(T.load_image(str(proot / "extracted" / name))
                   - j_T.load_image(str(jroot / "extracted" / name))) * 255
        assert d.max() <= PIXEL_MAX + 1e-3 and d.mean() <= PIXEL_MEAN, \
            (name, d.max(), d.mean())


def test_extract_command_runs_the_library(tmp_path):
    """`datasets grozi extract-test-images --root` writes what the
    library writes and prints its line; a layout whose videos are
    missing reports every frame, as cv2's reads of a missing file do."""
    lib, cli = tmp_path / "lib", tmp_path / "cli"
    layout(lib)
    shutil.copytree(lib, cli)
    said = _run(grozi.extract_grozi_test_imgs, str(lib))
    assert _run(cli_main, ["--device", "cpu", "datasets", "grozi",
                           "extract-test-images", "--root", str(cli)]) \
        == said
    for name in os.listdir(lib / "extracted"):
        assert (cli / "extracted" / name).read_bytes() == \
            (lib / "extracted" / name).read_bytes()
    shutil.rmtree(cli / "video")
    jroot = tmp_path / "jax"
    shutil.copytree(cli, jroot)
    said = _run(j_grozi.extract_grozi_test_imgs, str(jroot))
    assert _run(grozi.extract_grozi_test_imgs, str(cli)) == said
    assert said.count("Not all frames") == 2
    assert (cli / "extracted" / "index.txt").read_text() == ""
