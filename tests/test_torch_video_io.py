"""Port parity: the port's own copy of the video I/O
(thinkdiff_torch.data.video_io) against the JAX package's: the MJPEG AVI
writer gives the same bytes, each package's reader reads the other's file
to the same frames, the PNG-directory tier, the mp4 route (cv2's encoder,
else the ffmpeg binary, else an AVI beside the name) and decord's reader
surface."""

import shutil

import numpy as np
import pytest

from thinkdiff_torch.data import video_io as tv
from thinkdiff_tpu.data import video_io as jv


def _frames(n=5, h=32, w=48, seed=0):
    """Smooth gradients, one level apart a frame, plus a little noise."""
    rs = np.random.RandomState(seed)
    base = np.linspace(0, 200, w)[None, :, None] + np.zeros((h, 1, 3))
    return [np.clip(base + i + rs.randint(0, 3, (h, w, 3)), 0, 255)
            .astype(np.uint8) for i in range(n)]


@pytest.mark.parametrize("fps,quality", [(8, 92), (24, 75)])
def test_avi_bytes_equal_jax(tmp_path, fps, quality):
    frames = _frames()
    got = tv.write_mjpeg_avi(frames, str(tmp_path / "port.avi"), fps, quality)
    want = jv.write_mjpeg_avi(frames, str(tmp_path / "jax.avi"), fps, quality)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_readers_read_each_others_files(tmp_path):
    """The port's AVI through JAX's reader and JAX's through the port's:
    the same frames, count and fps; JPEG at quality 92 on these frames
    (measured mean |diff| 0.72 levels against the source; limit 3)."""
    frames = _frames(n=6)
    port_avi = tv.save_video(frames, str(tmp_path / "port.avi"), fps=12)
    jax_avi = jv.save_video(frames, str(tmp_path / "jax.avi"), fps=12)
    assert port_avi.endswith(".avi") and jax_avi.endswith(".avi")
    for a, b in ((tv.VideoReader(port_avi), jv.VideoReader(port_avi)),
                 (tv.VideoReader(jax_avi), jv.VideoReader(jax_avi))):
        assert len(a) == len(b) == 6
        # the header keeps whole microseconds a frame: 83333 at 12 fps
        assert a.get_avg_fps() == b.get_avg_fps() == 1e6 / 83333
        np.testing.assert_array_equal(a.get_batch(range(6)),
                                      b.get_batch(range(6)))
        np.testing.assert_array_equal(a[-1], b[5])
        got = a.get_batch([0, 5]).astype(int)
        assert got.shape == (2, 32, 48, 3)
        src = np.stack([frames[0], frames[5]]).astype(int)
        assert np.abs(got - src).mean() < 3


def test_png_directory_tier(tmp_path):
    """A path without a video extension is a directory of PNGs (lossless),
    the same files as JAX's."""
    frames = _frames(n=3)
    d = tv.save_video(frames, str(tmp_path / "port") + "/", fps=8)
    jv.save_video(frames, str(tmp_path / "jax") + "/", fps=8)
    r = tv.VideoReader(d.rstrip("/"))
    assert len(r) == 3
    np.testing.assert_array_equal(r.get_batch(range(3)), np.stack(frames))
    for i in range(3):
        name = f"frame_{i:05d}.png"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_mp4_route_and_its_fallback(tmp_path, monkeypatch):
    """mp4 through cv2 (in process) or the ffmpeg binary when either is
    there, as JAX's writer decides; with neither, an AVI beside the
    requested name (a container choice, as in JAX), readable."""
    frames = _frames(n=4)
    out = tv.save_video(frames, str(tmp_path / "clip.mp4"), fps=8)
    want = jv.save_video(frames, str(tmp_path / "jclip.mp4"), fps=8)
    assert out.endswith(want[-4:])
    if tv._cv2() is not None or shutil.which("ffmpeg"):
        assert out.endswith(".mp4")
    monkeypatch.setattr(tv, "_cv2", lambda: None)
    monkeypatch.setattr(tv.shutil, "which", lambda name: None)
    alt = tv.save_video(frames, str(tmp_path / "none.mp4"), fps=8)
    assert alt == str(tmp_path / "none.avi")
    assert len(tv.VideoReader(alt)) == 4
    with pytest.raises(ValueError, match="unsupported video extension"):
        tv.save_video(frames, str(tmp_path / "x.gif"))
    with pytest.raises(RuntimeError, match="needs cv2 or ffmpeg"):
        tv.VideoReader(str(tmp_path / "clip.mkv"))


def test_mp4_read_back_through_cv2(tmp_path):
    """Where cv2 has its avcodec backend: the port's mp4 read by both
    readers to the same frames, close to the source (MPEG-4 Part 2 on
    these frames: measured 2.68 levels mean; limit 8, JAX's own test's)."""
    if tv._cv2() is None:
        pytest.skip("cv2 FFMPEG backend not available")
    frames = _frames(n=6)
    path = tv.save_video(frames, str(tmp_path / "clip.mp4"), fps=12)
    a, b = tv.VideoReader(path), jv.VideoReader(path)
    assert len(a) == len(b) == 6
    got = a.get_batch(range(6))
    np.testing.assert_array_equal(got, b.get_batch(range(6)))
    assert np.abs(got.astype(int) - np.stack(frames).astype(int)).mean() < 8
