"""The robot perception loop: detect -> filter -> localize -> remember.

Python orchestration of the reference's frame loop
(KinectUtil::run/detection, src_yolo2/KinectUtil.cpp:52-487):

  1. acquire RGB-D frame (FrameSource)
  2. detect on TPU (LatencyEngine: fused preproc+forward+decode)
  3. per-event category whitelist (objectApplication.c:16-127)
  4. depth-ROI -> camera-space localization (C++ native)
  5. cross-frame object memory vote + "forgotten object" reminders
  6. KCF tracking between detector invocations (C++ native)
  7. sinks: natural-language writer ("i can see ..." — KinectUtil.cpp
     write_infor_to_txt:318-377) and a JSON-lines IPC stream standing in
     for the Thrift objectRecognized RPC (KinectUtil.cpp:466-482)
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional, Sequence

import numpy as np

from . import native
from .frame_source import FrameSource, RGBDFrame

# per-event category whitelists (objectApplication.c object_category_init:16)
EVENT_CATEGORIES = {
    "General": None,   # everything
    "ForgetBehavie": ["backpack", "handbag", "suitcase", "cell phone",
                      "umbrella", "book", "bottle", "cup", "laptop"],
    "Grasp": ["bottle", "cup", "apple", "orange", "banana", "book",
              "cell phone"],
    "Person_objects": ["backpack", "handbag", "suitcase", "cell phone"],
    "Demo_home": ["bottle", "cup", "chair", "sofa", "tvmonitor",
                  "laptop", "book"],
    "Demo_what": None,
}


class NLWriter:
    """'i can see a cup and a bottle' sentence sink
    (KinectUtil.cpp:318-377 writes res/Objects.txt)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.last_sentence = ""

    def write(self, names: Sequence[str]) -> str:
        uniq = list(dict.fromkeys(names))
        if not uniq:
            sentence = "i can not see anything"
        elif len(uniq) == 1:
            sentence = f"i can see a {uniq[0]}"
        else:
            sentence = ("i can see a " + ", a ".join(uniq[:-1])
                        + f" and a {uniq[-1]}")
        self.last_sentence = sentence
        if self.path:
            with open(self.path, "w") as f:
                f.write(sentence + "\n")
        return sentence


class IPCSink:
    """JSON-lines object stream: the transport-agnostic stand-in for the
    Thrift ObjectDetectionService client (KinectUtil.h:105). Failures
    are swallowed like the reference's catch-and-reset (the one graceful
    degradation site, KinectUtil.cpp:468-482)."""

    def __init__(self, path_or_fn):
        self._fn: Optional[Callable] = None
        self._path: Optional[str] = None
        if callable(path_or_fn):
            self._fn = path_or_fn
        else:
            self._path = path_or_fn
        self.failures = 0

    def object_recognized(self, objects: list[dict], timestamp: float):
        msg = {"type": "objectRecognized", "t": timestamp,
               "objects": [{"label": o.get("name", str(o["class_id"])),
                            "prob": round(float(o["prob"]), 4),
                            "xyz": [round(float(v), 4) for v in o["cam"]]}
                           for o in objects]}
        try:
            if self._fn:
                self._fn(msg)
            elif self._path:
                with open(self._path, "a") as f:
                    f.write(json.dumps(msg) + "\n")
        except Exception:
            self.failures += 1  # degrade gracefully, keep the frame loop


class RobotPerception:
    """The full per-frame pipeline."""

    def __init__(self, detector, *, names: Optional[Sequence[str]] = None,
                 event: str = "General", max_distance: float = 0.0,
                 detect_every: int = 1, nl_path: Optional[str] = None,
                 ipc=None, thresh: float = 0.24, nms: float = 0.1,
                 action_recognizer=None):
        """detector: infer.detector.Detector (or any object with a
        .detect(frame_float_hwc, thresh=, nms=) -> [Detection])."""
        self.detector = detector
        self.names = list(names) if names else None
        self.event = event
        self.max_distance = max_distance
        self.detect_every = max(1, detect_every)
        self.memory = native.ObjectMemory()
        self.tracks = native.MultiTracker()
        self.nl = NLWriter(nl_path)
        self.ipc = IPCSink(ipc) if ipc is not None else None
        self.thresh = thresh
        self.nms = nms
        self.frame_idx = 0
        self._trackers: list[tuple[native.KCFTracker, dict]] = []
        # per-body skeleton action recognition (Process_Kinect analog):
        # one robot.action.ActionRecognizer shared across bodies, fed
        # per-frame joints, flushed when a body disappears
        self.actions = action_recognizer
        self._skeleton_bufs: dict = {}

    def _allowed_ids(self) -> Optional[list[int]]:
        cats = EVENT_CATEGORIES.get(self.event)
        if cats is None or self.names is None:
            return None
        return [i for i, n in enumerate(self.names) if n in cats]

    def process(self, frame: RGBDFrame) -> dict:
        self.frame_idx += 1
        h, w = frame.color.shape[:2]

        if (self.frame_idx - 1) % self.detect_every == 0:
            img = frame.color.astype(np.float32) / 255.0
            detections = self.detector.detect(img, thresh=self.thresh,
                                              nms=self.nms)
            dets = [{"box": d.box, "prob": d.prob, "class_id": d.class_id,
                     "cam": (0.0, 0.0, 0.0), "body_id": -1}
                    for d in detections]
            # restart KCF trackers on fresh detections
            # (KinectUtil_with_cam.cpp InitialTracker:764)
            self._trackers = []
            for d in dets:
                t = native.KCFTracker()
                x, y, bw, bh = d["box"]
                t.init(frame.color, ((x - bw / 2) * w, (y - bh / 2) * h,
                                     bw * w, bh * h))
                self._trackers.append((t, d))
        else:
            # tracker-only frame (test_tracker_img:784)
            dets = []
            for t, d in self._trackers:
                x, y, bw, bh = t.track(frame.color)
                nd = dict(d)
                nd["box"] = ((x + bw / 2) / w, (y + bh / 2) / h,
                             bw / w, bh / h)
                dets.append(nd)

        allowed = self._allowed_ids()
        if allowed is not None:
            dets = [d for d in dets if d["class_id"] in allowed]

        if frame.depth is not None and dets:
            dets = native.localize(frame.depth, frame.intrinsics, dets)
            if self.max_distance > 0:
                dets = [d for d in dets
                        if 0 < d["cam"][2] <= self.max_distance]

        # person association via the body-index mask (objectBelong2Person)
        if frame.body_index is not None and dets:
            from .interaction import associate_person
            for d in dets:
                d["body_id"] = associate_person(d["box"], frame.body_index)

        # skeleton action recognition: buffer joints per body; classify
        # when a tracked body disappears (Process_Kinect.cpp:800-835)
        actions = []
        if self.actions is not None and frame.skeletons is not None:
            live = set(frame.skeletons)
            for bid, joints in frame.skeletons.items():
                self._skeleton_bufs.setdefault(bid, []).append(
                    np.asarray(joints, np.float32))
            for bid in list(self._skeleton_bufs):
                if bid not in live:
                    clip = self._skeleton_bufs.pop(bid)
                    for j in clip:
                        self.actions.push(j)
                    res = self.actions.flush()
                    if res:
                        actions.append({"body_id": bid,
                                        "action": res[0],
                                        "score": res[1]})

        dets = self.tracks.update(dets, w, h)
        self.memory.update(dets)
        stable = self.memory.objects()
        reminders = self.memory.reminders()

        for d in stable + reminders:
            if self.names:
                d["name"] = self.names[d["class_id"]]
        sentence = self.nl.write([d.get("name", str(d["class_id"]))
                                  for d in stable])
        if self.ipc is not None and stable:
            self.ipc.object_recognized(stable, frame.timestamp)

        if self.ipc is not None and actions:
            for a in actions:
                try:
                    self.ipc.object_recognized(
                        [{"name": a["action"], "prob": a["score"],
                          "class_id": -1, "cam": (0, 0, 0)}],
                        frame.timestamp)
                except Exception:
                    pass
        return {"detections": dets, "objects": stable,
                "reminders": reminders, "sentence": sentence,
                "actions": actions}

    def run(self, source: FrameSource, max_frames: int = 0) -> list[dict]:
        results = []
        for i, frame in enumerate(source):
            results.append(self.process(frame))
            if max_frames and i + 1 >= max_frames:
                break
        return results


__all__ = ["RobotPerception", "NLWriter", "IPCSink", "EVENT_CATEGORIES"]
