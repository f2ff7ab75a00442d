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
program of ``infer/quant.py``. A WordTree head (yolo9000) decodes through
the hierarchy: path probabilities (``ops.boxes.hierarchy_multiply``),
then with ``map_path`` the mapped classes' obj * path prob, or without a
map get_region_boxes' deepest-confident walk gated on objectness.
``presplit=True`` serves the folded, aligned head's (fields, cls) pair
and decodes it directly; ``presplit="flat"`` serves the flat pre-split
head, whose class lanes the decode slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import read_map
from ..graph import spec as S
from ..graph.compiler import Network
from ..io.convert import params_to_torch, params_to_numpy
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
                 presplit=False, quantize_head: bool = False):
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
        self.tree = self.net.trees.get(len(self.spec.layers) - 1)
        self.spec_served = self.spec     # the spec the forward runs
        if presplit:
            # the serving fast path of the JAX Detector: fold BN, align
            # the head and take the pre-split (fields, cls) pair, which
            # predict_batch decodes directly ("flat": the class tensor in
            # the head conv's layout, sliced there)
            from .engine import align_region_head, \
                fold_params_for_inference, presplit_spec
            params_f, fspec = fold_params_for_inference(
                self.spec, self.params, torch.float32)
            fspec, params_f = align_region_head(fspec, params_f,
                                                min_classes=1)
            fspec = presplit_spec(fspec, presplit)
            if fspec.layers[-1].presplit:
                self.spec_served = fspec
                self.params_np = params_to_numpy(fspec, params_f)
                self.net = Network(fspec, params_f)
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
        # the static side tables, once, on the device
        self.class_map = read_map(map_path) if map_path else None
        self._map = (None if self.class_map is None else torch.tensor(
            self.class_map, dtype=torch.int64, device=self.device))
        self._chain = (None if self.tree is None else
                       B.hierarchy_chain(self.tree.parent, self.device))

    def quantize(self, calib_x, *, quantize_head: bool = False,
                 region_dtype=None):
        """Swap the forward for the int8 program IN PLACE, calibrated on
        ``calib_x`` (preprocessed NHWC float32 sample batch, or a path
        saved with ``infer.quant.save_calib``). Reuses the loaded params
        (the folded, aligned ones with ``presplit``) and keeps every
        constructor setting; decode is unchanged. ``quantize_head`` runs
        the head conv in int8 too, ``region_dtype=torch.bfloat16`` the
        region decode in bf16 (the yolo9000 serving levers)."""
        from .quant import QuantizedForwardShim
        self.net = QuantizedForwardShim(
            self.spec_served, self.params_np, calib_x, device=self.device,
            quantize_head=quantize_head, region_dtype=region_dtype)

    @torch.no_grad()
    def predict_batch(self, x_nhwc, thresh: float = 0.0):
        """x: (B, net_h, net_w, 3) preprocessed (numpy or tensor).
        Returns (boxes (B, N, 4) relative, probs (B, N, classes)) with
        get_region_boxes' thresholding applied, on ``device``. For a
        tree head without a map the gate is objectness > thresh, so
        ``thresh`` is required there (region_layer.c:357-366)."""
        x = torch.as_tensor(x_nhwc, dtype=torch.float32).to(self.device)
        out, _ = self.net(x)
        r = self.region
        if isinstance(out, tuple):
            # pre-split: fields (B,H,W,A,coords+1) with the logistic obj
            # last, cls already softmaxed
            fields, cls = (t.float() for t in out)
            if cls.ndim == 4:
                # the flat pre-split head: anchor a's classes sit at
                # [a*block+128 : a*block+128+classes]
                blk = self.spec_served.layers[-1].head_block
                cls = torch.stack([cls[..., a * blk + 128:
                                       a * blk + 128 + r.classes]
                                   for a in range(r.n)], dim=3)
            boxes = B.decode_region_boxes(fields, self._anchors, img_w=1.0,
                                          img_h=1.0)
            obj = fields[..., r.coords]
        else:
            acts = out.float().reshape(x.shape[0], r.h, r.w, r.n,
                                       r.coords + r.classes + 1)
            boxes = B.decode_region_boxes(acts, self._anchors, img_w=1.0,
                                          img_h=1.0)
            obj = acts[..., 4]
            cls = acts[..., 5:]
        if self._chain is not None:
            cls = B.hierarchy_multiply(cls, self._chain)
        if r.classfix == -1:
            obj = torch.where(obj < 0.5, torch.zeros_like(obj), obj)
        if self._chain is not None and self._map is None:
            # get_region_boxes' no-map tree branch: the deepest-confident
            # path probability, gated on objectness > thresh
            cls = hierarchy_walk(cls)
            probs = torch.where(obj[..., None] > thresh, cls,
                                torch.zeros_like(cls))
        else:
            if self._chain is not None:
                cls = cls[..., self._map]
            probs = obj[..., None] * cls
            probs = torch.where(probs > thresh, probs,
                                torch.zeros_like(probs))
        b = x.shape[0]
        return boxes.reshape(b, -1, 4), probs.reshape(b, -1, probs.shape[-1])

    def preprocess(self, image_hwc: np.ndarray) -> np.ndarray:
        h, w = self.spec.net.h, self.spec.net.w
        if self.letterbox:
            return I.letterbox_image_np(image_hwc, w, h)
        return I.resize_image_np(image_hwc, w, h)

    @torch.no_grad()
    def detect(self, image_hwc: np.ndarray, *, thresh: float = 0.24,
               nms: float = 0.4, hier_thresh: float = 0.5
               ) -> list[Detection]:
        """Full single-image pipeline (test_detector semantics:
        thresh .24 default, nms .4 — detector.c:455,466). ``hier_thresh``
        keeps the JAX Detector's signature, but the walk's cut is
        get_region_boxes' fixed 0.5, so any other value raises."""
        if hier_thresh != 0.5:
            raise ValueError(f"hier_thresh={hier_thresh}: the hierarchy "
                             "walk's cut is fixed at 0.5")
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


def hierarchy_walk(path_probs):
    """get_region_boxes' deepest-confident-node walk
    (region_layer.c:356-366): scanning classes from last to first, keep
    only the first (highest-index) class whose path prob > .5 and zero
    the others; if none exceeds .5 everything is zeroed."""
    c = path_probs.shape[-1]
    idx = torch.arange(c, device=path_probs.device).expand_as(path_probs)
    masked = torch.where(path_probs > 0.5, idx, torch.full_like(idx, -1))
    top = masked.max(dim=-1, keepdim=True).values
    return torch.where(idx == top, path_probs, torch.zeros_like(path_probs))


__all__ = ["Detector", "Detection", "disable_tf32", "hierarchy_walk"]
