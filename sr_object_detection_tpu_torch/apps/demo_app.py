"""Streaming detection demo: fetch/detect overlap + temporal smoothing.

Counterpart of ``sr_object_detection_tpu/apps/demo_app.py``, the
reference's webcam demo (src_yolo2/demo.c:118-252): a fetch thread pulls
and preprocesses the next frame while the device detects the current
one, and predictions are averaged over a 3-frame ring (mean_arrays
smoothing, demo.c:79-81) before decode and NMS.

The ring holds the detector's outputs on its device; the average adds
them in ring order, ((p0 + p1) + p2), then divides by the count in
float32, as numpy's mean over the ring's axis does, so that the
smoothed probs equal the JAX demo's bit for bit. NMS goes through
``kernels/nms.py`` (the CUDA kernel on a CUDA detector).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..kernels import nms as NMS
from ..robot.frame_source import FrameSource

FRAMES = 3   # demo.c:30


def _on(t, device):
    """A detector output (tensor or array) as a float32 tensor on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, np.float32))
    return t.to(device, torch.float32)


def _ring_mean(ts):
    """mean over a list of equal-shape tensors, summed in list order."""
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t
    return acc / len(ts)


class StreamingDemo:
    def __init__(self, detector, source: FrameSource, *,
                 thresh: float = 0.24, nms: float = 0.4,
                 names=None, out_dir: Optional[str] = None):
        self.det = detector
        self.device = torch.device(getattr(detector, "device", "cpu"))
        self.source = source
        self.thresh = thresh
        self.nms = nms
        self.names = names
        self.out_dir = out_dir   # write annotated frames (demo OSD analog)
        self.ring = collections.deque(maxlen=FRAMES)
        self.fps = 0.0

    def _fetch(self, out):
        f = self.source.next()
        if f is None:
            out["frame"] = None
            return
        img = f.color.astype(np.float32) / 255.0
        out["frame"] = f
        out["x"] = self.det.preprocess(img)[None]

    def run(self, max_frames: int = 0, on_result=None):
        results = []
        pending: dict = {}
        self._fetch(pending)
        n = 0
        while pending.get("frame") is not None:
            cur = pending
            pending = {}
            # overlap: fetch the next frame while the device detects
            t = threading.Thread(target=self._fetch, args=(pending,))
            t.start()
            try:
                r = self._step(cur, n)
            finally:
                t.join()
            results.append(r)
            if on_result:
                on_result(r)
            n += 1
            if max_frames and n >= max_frames:
                break
        return results

    @torch.no_grad()
    def _step(self, cur, n):
        t0 = time.perf_counter()
        # tree-without-map models gate on objectness>thresh INSIDE the
        # decode (region_layer.c:365) — the thresh must reach
        # predict_batch there; plain models keep raw products so the
        # 3-frame average matches demo.c (average, then gate)
        kw = {}
        if (getattr(self.det, "tree", None) is not None
                and getattr(self.det, "class_map", None) is None):
            kw["thresh"] = self.thresh
        boxes, probs = self.det.predict_batch(cur["x"], **kw)
        self.ring.append((_on(boxes[0], self.device),
                          _on(probs[0], self.device)))
        # 3-frame prediction average (demo.c mean_arrays)
        avg_probs = _ring_mean([p for _, p in self.ring])
        avg_boxes = _ring_mean([b for b, _ in self.ring])
        probs_t = torch.where(avg_probs > self.thresh, avg_probs,
                              torch.zeros_like(avg_probs))
        if self.nms > 0:
            probs_t = NMS.nms_sort_topk(avg_boxes, probs_t, self.nms,
                                        k=min(128, probs_t.shape[0]))
        dets = self.det._collect(avg_boxes.cpu().numpy(),
                                 probs_t.cpu().numpy(), self.thresh)
        dt = time.perf_counter() - t0
        self.fps = 0.9 * self.fps + 0.1 * (1.0 / max(dt, 1e-6)) \
            if self.fps else 1.0 / max(dt, 1e-6)
        r = {"detections": dets, "fps": self.fps,
             "timestamp": cur["frame"].timestamp}
        if self.out_dir:
            from ..ops.draw import draw_detections
            from .nightmare_app import _save_ppm
            img = cur["frame"].color.astype(np.float32) / 255.0
            classes = getattr(getattr(self.det, "region", None),
                              "classes", 20)
            _save_ppm(os.path.join(self.out_dir, f"demo_{n:05d}.ppm"),
                      draw_detections(img, dets, classes))
        return r


__all__ = ["StreamingDemo", "FRAMES"]
