"""Video I/O without media libraries (the port's own copy of
thinkdiff_tpu/data/video_io.py; it imports nothing of that package).

ThinkDiff's video CLI saves an MP4 (diffusers' export_to_video) and its
data code reads videos with decord; neither ships here. Three tiers, the
best available wins:

  1. **MJPEG-in-AVI**, written and parsed in pure Python (a RIFF container,
     one JPEG a frame, playable everywhere): no dependency.
  2. **cv2's libavcodec backend** (in process): reads any container and
     codec avcodec decodes (mp4, h264, hevc, mpeg4, vp9) and writes mp4
     (MPEG-4 Part 2).
  3. **the ffmpeg binary** when present.

  - ``save_video(frames, path)``: .avi (pure Python) | .mp4 (cv2, else
    ffmpeg, else an AVI beside the requested name: a container choice, as
    the JAX package makes it) | a directory of PNGs (any path without a
    video extension)
  - ``VideoReader``: decord's surface (len, __getitem__, get_batch,
    get_avg_fps) over all three tiers.

Frames are numpy uint8 arrays on the host: video files are host data.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
from typing import List, Sequence

import numpy as np


def _cv2():
    """cv2 with a usable FFMPEG (libavcodec) videoio backend, else None."""
    try:
        import cv2
    except ImportError:
        return None
    try:
        backends = cv2.videoio_registry.getBackends()
        names = {cv2.videoio_registry.getBackendName(b) for b in backends}
    except AttributeError:  # very old cv2: assume the default build
        return cv2
    return cv2 if "FFMPEG" in names else None


# ------------------------------- writing ------------------------------------


def _jpeg_bytes(frame: np.ndarray, quality: int = 92) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(frames: Sequence[np.ndarray], path: str, fps: int = 8,
                    quality: int = 92) -> str:
    """frames: list of (H, W, 3) uint8 -> MJPEG AVI file."""
    assert len(frames) > 0, "no frames"
    h, w = frames[0].shape[:2]
    jpegs = [_jpeg_bytes(np.asarray(f, np.uint8), quality) for f in frames]
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 // fps), max_size * fps, 0, 0x10,  # usec/frame, rate, pad, HASINDEX
        len(jpegs), 0, 1, max_size, w, h, 0, 0, 0, 0,
    )
    strh = (b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIIII", 0, 0, 0, 0, 1, fps, 0, len(jpegs),
        max_size, 0xFFFFFFFF, 0, 0))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    strl = b"LIST" + struct.pack(
        "<I", 4 + len(chunk(b"strh", strh)) + len(chunk(b"strf", strf))
    ) + b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
    hdrl_body = b"hdrl" + chunk(b"avih", avih) + strl
    hdrl = b"LIST" + struct.pack("<I", len(hdrl_body)) + hdrl_body

    movi_chunks, idx, offset = [], [], 4
    for j in jpegs:
        c = chunk(b"00dc", j)
        movi_chunks.append(c)
        idx.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += len(c)
    movi_body = b"movi" + b"".join(movi_chunks)
    movi = b"LIST" + struct.pack("<I", len(movi_body)) + movi_body
    idx1 = chunk(b"idx1", b"".join(idx))

    riff_body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    return path


def save_video(frames, path: str, fps: int = 8) -> str:
    """frames: (T, H, W, 3) uint8 array or list of frames/PIL images."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    ext = os.path.splitext(path)[1].lower()
    if path.endswith(os.sep) or ext == "":
        os.makedirs(path, exist_ok=True)
        from PIL import Image

        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(path, f"frame_{i:05d}.png"))
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ext == ".avi":
        return write_mjpeg_avi(frames, path, fps=fps)
    if ext in (".mp4", ".mkv", ".webm"):
        cv2 = _cv2()
        if cv2 is not None and ext == ".mp4":
            # in-process avformat mux + MPEG-4 Part 2 encode (no h264
            # encoder in this avcodec build; any avcodec decoder — incl.
            # h264 — reads the result class of container fine)
            h, w = frames[0].shape[:2]
            vw = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            if vw.isOpened():
                for f in frames:
                    vw.write(f[..., ::-1])  # RGB -> BGR
                vw.release()
                return path
            vw.release()
        if shutil.which("ffmpeg"):
            tmp = path + ".tmp.avi"
            write_mjpeg_avi(frames, tmp, fps=fps)
            subprocess.run(["ffmpeg", "-y", "-i", tmp, "-pix_fmt", "yuv420p",
                            path], check=True, capture_output=True)
            os.remove(tmp)
            return path
        # no encoder available: fall back to AVI next to the requested name
        alt = os.path.splitext(path)[0] + ".avi"
        write_mjpeg_avi(frames, alt, fps=fps)
        return alt
    raise ValueError(f"unsupported video extension '{ext}'")


# ------------------------------- reading ------------------------------------


def _parse_riff_frames(data: bytes) -> List[bytes]:
    """Every '00dc'/'00db' chunk payload in an AVI byte string."""
    frames = []
    pos = 12  # RIFF....AVI_
    end = len(data)
    stack = [end]
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if fourcc in (b"LIST", b"RIFF"):
            pos += 12  # descend into the list
            continue
        if fourcc in (b"00dc", b"00db") and size:
            frames.append(data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size % 2)
    return frames


class VideoReader:
    """decord.VideoReader-compatible frame access (reference
    data_utils.py:18-29 bridges decord to torch; here frames are numpy).

    Pure-python for MJPEG AVI; other containers use ffmpeg when present.
    """

    def __init__(self, path: str):
        self.path = path
        self._jpegs = None
        self._files = None
        self._cap = None
        self._fps = 8.0
        if path.lower().endswith(".avi"):
            with open(path, "rb") as f:
                data = f.read()
            self._jpegs = _parse_riff_frames(data)
            if not self._jpegs:
                raise ValueError(f"no frames found in {path}")
            i = data.find(b"avih")
            if i >= 0:  # dwMicroSecPerFrame, first avih field
                usec = struct.unpack("<I", data[i + 8:i + 12])[0]
                if usec:
                    self._fps = 1e6 / usec
        elif os.path.isdir(path):
            self._files = sorted(
                os.path.join(path, n) for n in os.listdir(path)
                if n.endswith(".png"))
            if not self._files:
                raise ValueError(f"no frames found in {path}")
        elif _cv2() is not None:
            # in-process libavcodec decode (mp4/h264/hevc/mpeg4/vp9 — the
            # decord-parity path, reference data_utils.py:18-29). Frames
            # decode sequentially on demand and are cached, so get_batch
            # over sampled indices decodes only up to the highest index.
            cv2 = _cv2()
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise ValueError(f"avcodec cannot open {path}")
            self._fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 8.0
            self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self._cache: List[np.ndarray] = []
            if self._n <= 0:  # container with no frame index: decode all
                while True:
                    ok, frame = self._cap.read()
                    if not ok:
                        break
                    self._cache.append(frame[..., ::-1].copy())
                self._n = len(self._cache)
            if self._n <= 0:
                raise ValueError(f"no frames found in {path}")
        else:
            if not shutil.which("ffmpeg"):
                raise RuntimeError(
                    f"reading '{path}' needs cv2 or ffmpeg (only MJPEG .avi "
                    "and PNG directories are supported natively)")
            tmp = path + ".frames"
            os.makedirs(tmp, exist_ok=True)
            subprocess.run(
                ["ffmpeg", "-y", "-i", path,
                 os.path.join(tmp, "frame_%05d.png")],
                check=True, capture_output=True)
            self._files = sorted(
                os.path.join(tmp, n) for n in os.listdir(tmp))

    def __len__(self):
        if self._jpegs is not None:
            return len(self._jpegs)
        if self._files is not None:
            return len(self._files)
        return self._n

    def _decode(self, i: int) -> np.ndarray:
        if self._cap is not None:
            while len(self._cache) <= i:
                ok, frame = self._cap.read()
                if not ok:
                    raise IndexError(
                        f"frame {i} of {self._n} failed to decode")
                self._cache.append(frame[..., ::-1].copy())  # BGR -> RGB
            return self._cache[i]
        from PIL import Image

        if self._jpegs is not None:
            img = Image.open(io.BytesIO(self._jpegs[i]))
        else:
            img = Image.open(self._files[i])
        return np.asarray(img.convert("RGB"), np.uint8)

    def __getitem__(self, i: int) -> np.ndarray:
        if i < 0:
            i += len(self)
        return self._decode(i)

    def get_batch(self, indices) -> np.ndarray:
        return np.stack([self[int(i)] for i in indices])

    def get_avg_fps(self) -> float:
        return self._fps
