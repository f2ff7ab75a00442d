"""End-to-end detection pipeline: preprocess -> forward -> decode -> NMS.

Counterpart of ``sr_object_detection_tpu/infer/detector.py``, the analog
of the reference's ``test_detector`` (src_yolo2/detector.c:454-512) and
the C++ DLL ``Detector`` (yolo_v2_class.cpp:173-249). It runs in float32
and is pinned to the C-oracle goldens.

Parity notes:
  * the v2 detector path uses PLAIN resize, not letterbox
    (detector.c:483 resize_image) — letterbox is opt-in;
  * probs are objectness*class, zeroed at `thresh` BEFORE NMS
    (region_layer.c:368-373), NMS zeroes per class at IoU>nms
    (box.c:249-277) — on CUDA through the hand-written kernel
    (``kernels/nms.py``) — and a final per-box argmax picks the
    reported class (image.c draw_detections);
  * on CUDA, TF32 is switched off for convs and matmuls: cuDNN runs
    float32 convs in TF32 by default, which keeps about three digits.

``int8_calib`` / :meth:`Detector.quantize` swap the forward for the int8
program of ``infer/quant.py``. The pre-split head and WordTree models
are not ported yet (ROADMAP queue 1, items 4-5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import Network
from ..io.convert import params_to_torch
from ..io.weights import init_params, load_weights
from ..kernels import nms as NMS
from ..ops import boxes as B
from ..ops import image as I


@dataclasses.dataclass
class Detection:
    box: tuple[float, float, float, float]   # (x, y, w, h) center, relative
    class_id: int
    prob: float
    name: Optional[str] = None


def disable_tf32() -> None:
    """Full float32 on CUDA: cuDNN convs default to TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Detector:
    """Load a cfg+weights pair and run single/batched detection on
    ``device``."""

    def __init__(self, cfg_path: str, weights_path: Optional[str] = None,
                 *, device, names: Optional[Sequence[str]] = None,
                 letterbox: bool = False, map_path: Optional[str] = None,
                 nms_topk: int = 128, int8_calib=None,
                 presplit: bool = False, quantize_head: bool = False):
        if presplit:
            raise NotImplementedError(
                "the pre-split head is not ported yet (ROADMAP queue 1, "
                "item 5)")
        if map_path is not None:
            raise NotImplementedError(
                "WordTree class maps are not ported yet (ROADMAP queue 1, "
                "item 4)")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.spec = S.parse_network_cfg(cfg_path)
        if weights_path:
            params_np, self.seen = load_weights(self.spec, weights_path)
        else:
            params_np, self.seen = init_params(self.spec), 0
        self.params_np = params_np
        self.params = params_to_torch(self.spec, params_np, self.device)
        self.net = Network(self.spec, self.params)
        if int8_calib is not None:
            self.quantize(int8_calib, quantize_head=quantize_head)
        self.names = list(names) if names else None
        self.letterbox = letterbox
        self.nms_topk = nms_topk

        region = self.spec.layers[-1]
        if not isinstance(region, S.RegionSpec):
            raise ValueError("Detector requires a [region] final layer")
        self.region = region
        self._anchors = torch.tensor(
            np.asarray(region.anchors, np.float32).reshape(region.n, 2),
            device=self.device)

    def quantize(self, calib_x, *, quantize_head: bool = False,
                 region_dtype=None):
        """Swap the forward for the int8 program IN PLACE, calibrated on
        ``calib_x`` (preprocessed NHWC float32 sample batch, or a path
        saved with ``infer.quant.save_calib``). Reuses the loaded params
        and keeps every constructor setting; decode is unchanged."""
        from .quant import QuantizedForwardShim
        self.net = QuantizedForwardShim(
            self.spec, self.params_np, calib_x, device=self.device,
            quantize_head=quantize_head, region_dtype=region_dtype)

    @torch.no_grad()
    def predict_batch(self, x_nhwc, thresh: float = 0.0):
        """x: (B, net_h, net_w, 3) preprocessed (numpy or tensor).
        Returns (boxes (B, N, 4) relative, probs (B, N, classes)) with
        get_region_boxes' thresholding applied, on ``device``."""
        x = torch.as_tensor(x_nhwc, dtype=torch.float32).to(self.device)
        out, _ = self.net(x)
        r = self.region
        acts = out.float().reshape(x.shape[0], r.h, r.w, r.n,
                                   r.coords + r.classes + 1)
        boxes = B.decode_region_boxes(acts, self._anchors, img_w=1.0,
                                      img_h=1.0)
        obj = acts[..., 4]
        if r.classfix == -1:
            obj = torch.where(obj < 0.5, torch.zeros_like(obj), obj)
        probs = obj[..., None] * acts[..., 5:]
        probs = torch.where(probs > thresh, probs, torch.zeros_like(probs))
        b = x.shape[0]
        return boxes.reshape(b, -1, 4), probs.reshape(b, -1, probs.shape[-1])

    def preprocess(self, image_hwc: np.ndarray) -> np.ndarray:
        h, w = self.spec.net.h, self.spec.net.w
        if self.letterbox:
            return I.letterbox_image_np(image_hwc, w, h)
        return I.resize_image_np(image_hwc, w, h)

    @torch.no_grad()
    def detect(self, image_hwc: np.ndarray, *, thresh: float = 0.24,
               nms: float = 0.4) -> list[Detection]:
        """Full single-image pipeline (test_detector semantics:
        thresh .24 default, nms .4 — detector.c:455,466)."""
        x = self.preprocess(image_hwc)[None]
        boxes, probs = self.predict_batch(x, thresh=thresh)
        boxes, probs = boxes[0], probs[0]
        if nms > 0:
            probs = NMS.nms_sort_topk(boxes, probs, nms,
                                      k=min(self.nms_topk, probs.shape[0]))
        return self._collect(boxes.cpu().numpy(), probs.cpu().numpy(),
                             thresh)

    def _collect(self, boxes, probs, thresh) -> list[Detection]:
        dets = []
        cls = probs.argmax(axis=1)
        p = probs[np.arange(len(cls)), cls]
        for i in np.nonzero(p > thresh)[0]:
            name = None
            if self.names:
                name = self.names[int(cls[i])]
            dets.append(Detection(
                box=tuple(float(v) for v in boxes[i]),
                class_id=int(cls[i]), prob=float(p[i]), name=name))
        dets.sort(key=lambda d: -d.prob)
        return dets


__all__ = ["Detector", "Detection", "disable_tf32"]
