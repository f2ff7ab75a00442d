"""Hand-ROI detection, person association, and speech output.

The remaining robot-interaction pieces of the reference:
  * hand-ROI sub-detection — crop a window around a hand joint and run
    the detector on just that region ("what is in my hand",
    KinectUtil_with_cam.cpp:903-1256 objectDetectionLocal);
  * person association — vote each detection's box against a
    body-index mask to find which tracked person it belongs to
    (objectBelong2Person, KinectUtil_with_cam.cpp:1632);
  * TTS — the reference shells out to a SAPI helper (voice.cpp,
    WinExec "voice.exe ..."): here a Speaker interface with pluggable
    sinks (stdout, file, callback) plus the scripted replies of
    object2str (KinectUtil_with_cam.cpp:805-875).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def hand_roi(frame_hwc: np.ndarray, hand_xy: tuple[float, float],
             roi_size: int = 128) -> tuple[np.ndarray, tuple[int, int]]:
    """Crop a square window centered on the hand joint (pixel coords),
    clamped to the frame. Returns (crop, (x0, y0))."""
    h, w = frame_hwc.shape[:2]
    cx, cy = int(hand_xy[0]), int(hand_xy[1])
    half = roi_size // 2
    x0 = max(0, min(cx - half, w - roi_size))
    y0 = max(0, min(cy - half, h - roi_size))
    return frame_hwc[y0:y0 + roi_size, x0:x0 + roi_size], (x0, y0)


def detect_in_hand(detector, frame_hwc: np.ndarray,
                   hand_xy: tuple[float, float], *, roi_size: int = 128,
                   thresh: float = 0.2, nms: float = 0.1):
    """Run the detector on the hand window; detections come back in
    full-frame relative coordinates."""
    crop, (x0, y0) = hand_roi(frame_hwc, hand_xy, roi_size)
    img = crop.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    dets = detector.detect(img, thresh=thresh, nms=nms)
    h, w = frame_hwc.shape[:2]
    ch, cw = crop.shape[:2]
    out = []
    for d in dets:
        x, y, bw, bh = d.box
        d.box = ((x0 + x * cw) / w, (y0 + y * ch) / h,
                 bw * cw / w, bh * ch / h)
        out.append(d)
    return out


def associate_person(det_box, body_index: np.ndarray,
                     min_fraction: float = 0.2) -> int:
    """objectBelong2Person (KinectUtil_with_cam.cpp:1632): vote the
    pixels of the detection ROI against the body-index mask; the body id
    owning the plurality of non-background pixels wins.

    det_box: (x, y, w, h) relative; body_index: (H, W) uint8 with 255 =
    no body (the Kinect convention). Returns body id or -1.
    """
    h, w = body_index.shape
    x, y, bw, bh = det_box
    x0 = max(0, int((x - bw / 2) * w))
    x1 = min(w, int((x + bw / 2) * w) + 1)
    y0 = max(0, int((y - bh / 2) * h))
    y1 = min(h, int((y + bh / 2) * h) + 1)
    roi = body_index[y0:y1, x0:x1]
    if roi.size == 0:
        return -1
    vals, counts = np.unique(roi[roi != 255], return_counts=True)
    if len(vals) == 0:
        return -1
    best = int(np.argmax(counts))
    if counts[best] < min_fraction * roi.size:
        return -1
    return int(vals[best])


# scripted replies (object2str, KinectUtil_with_cam.cpp:805-875)
_REPLIES = {
    "cup": "this is a cup, would you like some water",
    "bottle": "i see a bottle, are you thirsty",
    "book": "that is a book, do you enjoy reading",
    "cell phone": "you are holding a cell phone",
    "apple": "that apple looks delicious",
}


def heuristic_face_count(rgb_hwc: np.ndarray, *, min_frac: float = 0.002,
                         max_frac: float = 0.25) -> int:
    """Dependency-free face-count stand-in: skin-tone mask + connected
    blobs of plausible size. The reference counts Haar-cascade hits and
    uses ONLY the count (Process_Kinect.cpp detectFaces:1704-1725
    returns faces.size(); the drawing code is commented out), so the
    hook contract is an int count, not boxes."""
    x = np.asarray(rgb_hwc, np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    skin = ((r > 0.35) & (r > g) & (g > b) & (r - b > 0.1)
            & (r - g > 0.02))
    # 4-connected blob count via two-pass flood on a coarse grid
    mask = skin[::4, ::4]
    lab = np.zeros(mask.shape, np.int32)
    cur = 0
    stack = []
    h, w = mask.shape
    for i in range(h):
        for j in range(w):
            if mask[i, j] and lab[i, j] == 0:
                cur += 1
                stack.append((i, j))
                size = 0
                while stack:
                    a, b_ = stack.pop()
                    if a < 0 or a >= h or b_ < 0 or b_ >= w:
                        continue
                    if not mask[a, b_] or lab[a, b_] != 0:
                        continue
                    lab[a, b_] = cur
                    size += 1
                    stack.extend([(a + 1, b_), (a - 1, b_),
                                  (a, b_ + 1), (a, b_ - 1)])
                frac = size / mask.size
                if not (min_frac <= frac <= max_frac):
                    lab[lab == cur] = -1        # reject: too small/large
                    cur -= 1
    return cur


class FaceCounter:
    """Pluggable face-detection hook (Process_Kinect::detectFaces
    analog). Pass any callable rgb -> int (e.g. a real cascade or a
    model-backed detector); defaults to the skin-blob heuristic."""

    def __init__(self, detector: Optional[Callable[[np.ndarray], int]]
                 = None):
        self.detector = detector or heuristic_face_count
        self.last_count = 0

    def __call__(self, rgb_hwc: np.ndarray) -> int:
        self.last_count = int(self.detector(rgb_hwc))
        return self.last_count


def object_reply(name: str) -> str:
    return _REPLIES.get(name, f"i can see a {name}")


class Speaker:
    """TTS abstraction: the reference launches 'voice.exe <text>'
    (voice.cpp:6-33 SAPI); sinks here are pluggable so robot tests run
    headless. Repeated sentences are de-duplicated like the reference's
    send2VirtualHuman (objectApplication.c:241)."""

    def __init__(self, sink: Optional[Callable[[str], None]] = None,
                 dedup: bool = True):
        self.sink = sink or (lambda s: print(f"[speak] {s}"))
        self.dedup = dedup
        self.last: Optional[str] = None
        self.history: list[str] = []

    def speak(self, text: str) -> bool:
        if self.dedup and text == self.last:
            return False
        self.last = text
        self.history.append(text)
        self.sink(text)
        return True

    def speak_objects(self, names: Sequence[str]) -> bool:
        if not names:
            return False
        return self.speak(object_reply(names[0]))


__all__ = ["hand_roi", "detect_in_hand", "associate_person",
           "object_reply", "Speaker", "FaceCounter",
           "heuristic_face_count"]
