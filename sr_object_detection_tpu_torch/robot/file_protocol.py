"""Shared-text-file detection exchange — the speech-api variant's IPC.

The reference's no-GPU/speech-api robot build has no in-process
detector: another process writes detections to a shared txt file and
the robot loop busy-waits, parses, and deletes it
(KinectUtil_speech_api.cpp:320-407 read_infor_from_txt); a companion
writer emits the spoken-sentence file
(KinectUtil.cpp:318-377 write_infor_to_txt).

This module provides both ends, byte-compatible with the reference
reader's expectations: 'objNumber = N' then, per object, one separator
line followed by exactly 7 'key = value' lines
(x, y, w, h, name, prob, objClass — the reader consumes 7 getlines and
substr-parses 'name = ' at offset 7). Coordinates are pixels
(top-left x,y + size), matching the draw_text_box overlay space.

`FileProtocolDetector` adapts the reader to the RobotPerception
detector interface (.detect -> [Detection]), giving the pipeline a
cross-process detector with no model in-process.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

from ..infer.detector import Detection


def write_detection_txt(path: str, detections: Sequence[Detection],
                        frame_w: int, frame_h: int,
                        names: Optional[Sequence[str]] = None) -> None:
    """Producer side of read_infor_from_txt's format. Writes atomically
    (tmp+rename) so a concurrently polling reader never sees a torn
    file — the failure mode the reference's busy-wait loop papers
    over."""
    lines = [f"objNumber = {len(detections)}"]
    for i, d in enumerate(detections):
        x, y, w, h = d.box
        px = x * frame_w - w * frame_w / 2
        py = y * frame_h - h * frame_h / 2
        name = d.name or (names[d.class_id] if names else str(d.class_id))
        lines.append(f"object {i}")
        lines.append(f"x = {px:.2f}")
        lines.append(f"y = {py:.2f}")
        lines.append(f"w = {w * frame_w:.2f}")
        lines.append(f"h = {h * frame_h:.2f}")
        lines.append(f"name = {name}")
        lines.append(f"prob = {d.prob:.4f}")
        lines.append(f"objClass = {d.class_id}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def read_detection_txt(path: str, frame_w: int, frame_h: int, *,
                       timeout: float = 0.0, poll: float = 0.01,
                       delete: bool = True) -> list[Detection]:
    """Consumer side (read_infor_from_txt semantics): wait for the file
    (bounded, unlike the reference's unbounded spin), parse the
    key=value blocks, delete the file so the producer knows it was
    consumed. Returns [] on timeout."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() >= deadline:
            return []
        time.sleep(poll)
    with open(path) as f:
        raw = f.read().splitlines()
    if delete:
        os.remove(path)

    dets: list[Detection] = []
    it = iter(raw)
    for line in it:
        parts = line.split()
        if len(parts) >= 3 and parts[0] == "objNumber" and parts[1] == "=":
            n = int(parts[2])
            for _ in range(n):
                next(it, None)                      # separator line
                fields = {}
                for _ in range(7):
                    fl = next(it, "")
                    k, _, v = fl.partition(" = ")
                    fields[k.strip()] = v
                try:
                    px, py = float(fields["x"]), float(fields["y"])
                    pw, ph = float(fields["w"]), float(fields["h"])
                    dets.append(Detection(
                        box=((px + pw / 2) / frame_w,
                             (py + ph / 2) / frame_h,
                             pw / frame_w, ph / frame_h),
                        class_id=int(fields["objClass"]),
                        prob=float(fields["prob"]),
                        name=fields.get("name") or None))
                except (KeyError, ValueError):
                    continue                        # skip torn block
    return dets


def write_speech_txt(path: str, names: Sequence[str]) -> str:
    """The spoken-sentence file (write_infor_to_txt,
    KinectUtil.cpp:318-377): dedupe by first appearance, then the
    reference's exact three-way phrasing."""
    uniq = list(dict.fromkeys(names))
    if not uniq:
        sentence = "there is nothing in this room!"
    elif len(uniq) == 1:
        sentence = f"i can see {uniq[0]}."
    else:
        head = ", ".join(uniq[:-2])
        mid = uniq[-2]
        sentence = ("there are many things in this room. i can see "
                    + (head + ", " if head else "")
                    + f"{mid} and {uniq[-1]}.")
    with open(path, "w") as f:
        f.write(sentence)
    return sentence


class FileProtocolDetector:
    """Detector-shaped adapter over the shared file: RobotPerception
    can run with NO model in this process (the speech-api deployment
    shape — detection happens elsewhere, KinectUtil_speech_api.cpp's
    main loop)."""

    def __init__(self, path: str, *, timeout: float = 1.0):
        self.path = path
        self.timeout = timeout

    def detect(self, frame_hwc, *, thresh: float = 0.24,
               nms: float = 0.4, **_) -> list[Detection]:
        h, w = frame_hwc.shape[:2]
        dets = read_detection_txt(self.path, w, h, timeout=self.timeout)
        return [d for d in dets if d.prob > thresh]


__all__ = ["write_detection_txt", "read_detection_txt",
           "write_speech_txt", "FileProtocolDetector"]
