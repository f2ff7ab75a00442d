"""Frame sources: the hardware abstraction replacing the Kinect v2.

The reference hardwires Kinect SDK frame acquisition
(KinectUtil.cpp:115-204: depth 512x424 uint16 mm + color 1920x1080).
Headless-testable sources implement the same contract:

    frame = source.next()  ->  RGBDFrame(color u8 HWC, depth u16 mm,
                                          intrinsics, timestamp)
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Iterator, Optional

import numpy as np


KINECT_DEPTH_SIZE = (424, 512)            # KinectUtil.cpp:115
KINECT_COLOR_SIZE = (1080, 1920)
# Kinect v2 depth intrinsics (public calibration values)
KINECT_INTRINSICS = (365.456, 365.456, 254.878, 205.395)


@dataclasses.dataclass
class RGBDFrame:
    color: np.ndarray                     # (H, W, 3) uint8
    depth: Optional[np.ndarray]           # (Hd, Wd) uint16 mm or None
    intrinsics: tuple = KINECT_INTRINSICS
    timestamp: float = 0.0
    # tracked skeletons: {body_id: (J, 3) camera-space joints}
    # (the Kinect Body frame analog, Process_Kinect.cpp:1029-1200)
    skeletons: Optional[dict] = None
    # per-pixel body index mask, 255 = background (BodyIndex frame)
    body_index: Optional[np.ndarray] = None


class FrameSource:
    def next(self) -> Optional[RGBDFrame]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RGBDFrame]:
        while True:
            f = self.next()
            if f is None:
                return
            yield f


class SyntheticRGBDSource(FrameSource):
    """Deterministic synthetic scene: a textured 'table' plane in depth
    plus a few moving colored boxes — lets the full robot pipeline
    (detect, localize, plane removal, tracking, reminders) run headless.
    """

    def __init__(self, w: int = 512, h: int = 424, n_frames: int = 100,
                 seed: int = 0):
        self.w, self.h = w, h
        self.n_frames = n_frames
        self.i = 0
        self.rng = np.random.default_rng(seed)
        fx = fy = 365.0
        self.intr = (fx, fy, w / 2.0, h / 2.0)

    def next(self) -> Optional[RGBDFrame]:
        if self.i >= self.n_frames:
            return None
        t = self.i
        self.i += 1
        h, w = self.h, self.w
        color = np.full((h, w, 3), 64, np.uint8)
        depth = np.zeros((h, w), np.uint16)
        # table plane at z = 1.5m across the lower half
        depth[h // 2:, :] = 1500
        # a box sliding right at z = 1.0m
        bx = int((0.2 + 0.004 * t) * w) % w
        by = int(0.4 * h)
        bw, bh = w // 8, h // 8
        color[by:by + bh, bx:bx + bw] = (200, 40, 40)
        depth[by:by + bh, bx:bx + bw] = 1000
        # a static box at z = 0.8m
        sx, sy = int(0.7 * w), int(0.25 * h)
        color[sy:sy + bh, sx:sx + bw] = (40, 200, 40)
        depth[sy:sy + bh, sx:sx + bw] = 800
        return RGBDFrame(color=color, depth=depth, intrinsics=self.intr,
                         timestamp=float(t) / 30.0)


class ImageDirectorySource(FrameSource):
    """Replays a directory of images as the color stream (the headless
    stand-in for 'detector demo' video input; depth absent)."""

    def __init__(self, pattern: str, loop: bool = False):
        self.paths = sorted(glob.glob(pattern))
        if not self.paths:
            raise ValueError(f"no frames match {pattern!r}")
        self.i = 0
        self.loop = loop

    def next(self) -> Optional[RGBDFrame]:
        if self.i >= len(self.paths):
            if not self.loop:
                return None
            self.i = 0
        from ..ops.image import load_image_rgb
        img = (load_image_rgb(self.paths[self.i]) * 255).astype(np.uint8)
        self.i += 1
        return RGBDFrame(color=img, depth=None, timestamp=time.time())


class RawRGBDSource(FrameSource):
    """Binary RGB-D dump replay: pairs of <stem>.rgb (u8 HWC) and
    <stem>.depth (u16) files with a small header — the capture format
    our recorder writes (the analog of the reference's shared-folder
    txt protocol for offline robot testing)."""

    def __init__(self, directory: str):
        self.stems = sorted(
            p[:-4] for p in glob.glob(os.path.join(directory, "*.rgb")))
        self.i = 0

    @staticmethod
    def write_frame(stem: str, frame: RGBDFrame):
        h, w = frame.color.shape[:2]
        with open(stem + ".rgb", "wb") as f:
            f.write(np.array([h, w], np.int32).tobytes())
            f.write(frame.color.tobytes())
        if frame.depth is not None:
            dh, dw = frame.depth.shape
            with open(stem + ".depth", "wb") as f:
                f.write(np.array([dh, dw], np.int32).tobytes())
                f.write(frame.depth.tobytes())

    def next(self) -> Optional[RGBDFrame]:
        if self.i >= len(self.stems):
            return None
        stem = self.stems[self.i]
        self.i += 1
        with open(stem + ".rgb", "rb") as f:
            h, w = np.frombuffer(f.read(8), np.int32)
            color = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)
        depth = None
        if os.path.exists(stem + ".depth"):
            with open(stem + ".depth", "rb") as f:
                dh, dw = np.frombuffer(f.read(8), np.int32)
                depth = np.frombuffer(f.read(), np.uint16).reshape(dh, dw)
        return RGBDFrame(color=color.copy(),
                         depth=None if depth is None else depth.copy(),
                         timestamp=float(self.i) / 30.0)


__all__ = ["RGBDFrame", "FrameSource", "SyntheticRGBDSource",
           "ImageDirectorySource", "RawRGBDSource", "VideoFileSource",
           "V4L2FrameSource", "KINECT_INTRINSICS"]


class VideoFileSource(FrameSource):
    """Live video decode for `detector demo` (demo.c:57
    cvCaptureFromFile / get_image_from_stream): streams frames out of a
    real video file instead of an image directory.

    Two decode backends, chosen by availability:
      * PIL multi-frame containers (.gif/.tiff/.webp) — in-process,
        zero external deps; animated GIF is the test vehicle;
      * everything else (mp4/avi/mkv/...) through an ffmpeg rawvideo
        pipe (``ffmpeg -i f -f rawvideo -pix_fmt rgb24 -``), geometry
        probed with ffprobe — the deployment path when the binary
        exists.
    """

    _PIL_MULTIFRAME = (".gif", ".tif", ".tiff", ".webp", ".apng",
                       ".png")

    def __init__(self, path: str, loop: bool = False):
        self.path = path
        self.loop = loop
        ext = os.path.splitext(path)[1].lower()
        self._proc = None
        if ext in self._PIL_MULTIFRAME:
            self._mode = "pil"
            self._open_pil()
        else:
            import shutil
            if shutil.which("ffmpeg") is None:
                raise RuntimeError(
                    f"decoding {ext!r} needs ffmpeg on PATH (PIL "
                    f"handles {'/'.join(self._PIL_MULTIFRAME)})")
            self._mode = "ffmpeg"
            self._open_ffmpeg()

    # -- PIL backend ---------------------------------------------------
    def _open_pil(self):
        from PIL import Image, ImageSequence
        self._img = Image.open(self.path)
        self._frames = ImageSequence.Iterator(self._img)
        self._it = iter(self._frames)

    # -- ffmpeg backend ------------------------------------------------
    def _open_ffmpeg(self):
        import json
        import subprocess
        probe = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height", "-of", "json",
             self.path], capture_output=True, text=True, check=True)
        st = json.loads(probe.stdout)["streams"][0]
        self._w, self._h = int(st["width"]), int(st["height"])
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-i", self.path, "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-"],
            stdout=subprocess.PIPE)

    def next(self) -> Optional[RGBDFrame]:
        if self._mode == "pil":
            try:
                frame = next(self._it)
            except StopIteration:
                if not self.loop:
                    return None
                self._open_pil()
                frame = next(self._it)
            arr = np.asarray(frame.convert("RGB"), np.uint8)
            return RGBDFrame(color=arr, depth=None,
                             timestamp=time.time())
        buf = self._proc.stdout.read(self._w * self._h * 3)
        if len(buf) < self._w * self._h * 3:
            self._proc.stdout.close()
            self._proc.wait()
            if not self.loop:
                return None
            self._open_ffmpeg()
            buf = self._proc.stdout.read(self._w * self._h * 3)
            if len(buf) < self._w * self._h * 3:
                return None
        arr = np.frombuffer(buf, np.uint8).reshape(self._h, self._w, 3)
        return RGBDFrame(color=arr, depth=None, timestamp=time.time())


class V4L2FrameSource(FrameSource):
    """LIVE camera capture — the cvCaptureFromCAM device-index path of
    `detector demo` (src_yolo2/demo.c:57 cvCaptureFromCAM(cam_index))
    and the Kinect color sensor loop (KinectUtil.cpp:171-204): streams
    rawvideo RGB24 from a Video4Linux2 device through an
    ``ffmpeg -f v4l2`` pipe.

    No camera exists in this environment, so the input half of the
    ffmpeg command is injectable (``_input_args``) — the test
    substitutes an ``-f lavfi testsrc`` synthetic camera and exercises
    the identical read loop, geometry handling, and shutdown path the
    real device would use.
    """

    def __init__(self, device: str = "/dev/video0", *,
                 width: int = 640, height: int = 480, fps: int = 30,
                 _input_args: Optional[list] = None):
        import shutil
        import subprocess
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("live capture needs ffmpeg on PATH")
        if _input_args is None and not os.path.exists(device):
            raise RuntimeError(f"no camera device {device!r}")
        self._w, self._h = width, height
        inp = list(_input_args) if _input_args is not None else [
            "-f", "v4l2", "-framerate", str(fps),
            "-video_size", f"{width}x{height}", "-i", device]
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", *inp,
             "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-s", f"{width}x{height}", "-"],
            stdout=subprocess.PIPE)

    def next(self) -> Optional[RGBDFrame]:
        need = self._w * self._h * 3
        buf = self._proc.stdout.read(need)
        if len(buf) < need:                      # device closed / EOF
            self.close()
            return None
        arr = np.frombuffer(buf, np.uint8).reshape(self._h, self._w, 3)
        return RGBDFrame(color=arr, depth=None, timestamp=time.time())

    def close(self):
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:
                self._proc.kill()
        if self._proc.stdout:
            self._proc.stdout.close()
