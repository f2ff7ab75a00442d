"""VOC detection evaluation: AP / mAP / recall harness + result writers.

Re-implements the math of the reference's offline scorers
(scripts/voc_eval.py:31-200 — 11-point and area-under-PR AP at IoU .5,
greedy confidence-ordered matching, difficult boxes excluded) and the
inline proposal-recall harness (src_yolo2/detector.c:371-450), plus the
VOC/COCO/ImageNet detection-file writers of validate_detector
(detector.c:175-242).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (voc_eval.py:31-61)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_corners(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """IoU of one [x1,y1,x2,y2] box vs (N,4) gts, VOC pixel semantics
    (voc_eval.py:150-163: +1 inclusive widths)."""
    ixmin = np.maximum(gts[:, 0], box[0])
    iymin = np.maximum(gts[:, 1], box[1])
    ixmax = np.minimum(gts[:, 2], box[2])
    iymax = np.minimum(gts[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    uni = ((box[2] - box[0] + 1) * (box[3] - box[1] + 1)
           + (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
           - inter)
    return inter / uni


@dataclasses.dataclass
class ClassEval:
    ap: float
    recall: np.ndarray
    precision: np.ndarray
    npos: int


def eval_class(detections: Sequence[tuple], gt: dict,
               iou_thresh: float = 0.5,
               use_07_metric: bool = False) -> ClassEval:
    """One class (voc_eval.py:64-200).

    detections: iterable of (image_id, confidence, x1, y1, x2, y2).
    gt: {image_id: {'boxes': (N,4) corners, 'difficult': (N,) bool}}.
    """
    npos = 0
    state = {}
    for img, g in gt.items():
        boxes = np.asarray(g["boxes"], np.float32).reshape(-1, 4)
        difficult = np.asarray(
            g.get("difficult", np.zeros(len(boxes), bool)), bool)
        npos += int((~difficult).sum())
        state[img] = {"boxes": boxes, "difficult": difficult,
                      "det": np.zeros(len(boxes), bool)}

    dets = sorted(detections, key=lambda d: -d[1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img, conf, x1, y1, x2, y2) in enumerate(dets):
        g = state.get(img)
        if g is None or len(g["boxes"]) == 0:
            fp[i] = 1
            continue
        ious = _iou_corners(np.array([x1, y1, x2, y2], np.float32),
                            g["boxes"])
        j = int(np.argmax(ious))
        if ious[j] > iou_thresh:
            if not g["difficult"][j]:
                if not g["det"][j]:
                    tp[i] = 1
                    g["det"][j] = True
                else:
                    fp[i] = 1
        else:
            fp[i] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    rec = ctp / max(npos, 1)
    prec = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
    return ClassEval(ap=voc_ap(rec, prec, use_07_metric),
                     recall=rec, precision=prec, npos=npos)


def mean_ap(per_class_dets: dict, per_class_gt: dict,
            iou_thresh: float = 0.5, use_07_metric: bool = False):
    """Returns (mAP, {class: ap})."""
    aps = {}
    for cls in per_class_gt:
        aps[cls] = eval_class(per_class_dets.get(cls, []),
                              per_class_gt[cls], iou_thresh,
                              use_07_metric).ap
    m = float(np.mean(list(aps.values()))) if aps else 0.0
    return m, aps


# ---------------------------------------------------------------------------
# Detection-file writers (validate_detector, detector.c:175-242)
# ---------------------------------------------------------------------------


def voc_det_lines(image_id: str, boxes: np.ndarray, probs: np.ndarray,
                  class_names: Sequence[str], img_w: int, img_h: int):
    """Per-class VOC lines: 'id conf x1 y1 x2 y2' clamped to
    [0,w]x[0,h] (print_detector_detections, detector.c:201-220 — this
    fork dropped upstream darknet's 1-based +1 shift).

    boxes are (N,4) center-relative; probs (N,C)."""
    out = {name: [] for name in class_names}
    for i in range(len(boxes)):
        x, y, w, h = boxes[i]
        xmin = x * img_w - w * img_w / 2.0
        xmax = x * img_w + w * img_w / 2.0
        ymin = y * img_h - h * img_h / 2.0
        ymax = y * img_h + h * img_h / 2.0
        xmin = max(xmin, 0.0)
        ymin = max(ymin, 0.0)
        xmax = min(xmax, float(img_w))
        ymax = min(ymax, float(img_h))
        for j, name in enumerate(class_names):
            if probs[i, j] > 0:
                out[name].append(
                    f"{image_id} {probs[i, j]:f} {xmin:f} {ymin:f} "
                    f"{xmax:f} {ymax:f}")
    return out


def coco_det_records(image_id: int, boxes: np.ndarray, probs: np.ndarray,
                     coco_ids: Sequence[int], img_w: int, img_h: int):
    """COCO-format records (print_cocos, detector.c:175-199)."""
    recs = []
    for i in range(len(boxes)):
        x, y, w, h = boxes[i]
        bx = max(x * img_w - w * img_w / 2.0, 0.0)
        by = max(y * img_h - h * img_h / 2.0, 0.0)
        bw = min(w * img_w, img_w - bx)
        bh = min(h * img_h, img_h - by)
        for j, cid in enumerate(coco_ids):
            if probs[i, j] > 0:
                recs.append({"image_id": image_id, "category_id": int(cid),
                             "bbox": [round(float(v), 2)
                                      for v in (bx, by, bw, bh)],
                             "score": float(probs[i, j])})
    return recs


def _iou_centers_pairwise(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix (len(a), len(b)) for center-format (x,y,w,h) boxes —
    box_iou (box.c:135) math in pure numpy."""
    a = a[:, None, :]
    b = b[None, :, :]
    lo = np.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    hi = np.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def proposal_recall(all_boxes: Sequence[np.ndarray],
                    all_obj: Sequence[np.ndarray],
                    all_gt: Sequence[np.ndarray],
                    thresh: float = 0.24,
                    iou_thresh: float = 0.5):
    """validate_detector_recall (detector.c:371-450): proposals above
    `thresh` objectness; a GT counts as recalled if its best-IoU
    proposal exceeds iou_thresh. boxes/gt are center-relative (N,4)."""
    total = correct = proposals = 0
    iou_sum = 0.0
    for boxes, obj, gts in zip(all_boxes, all_obj, all_gt):
        keep = np.asarray(obj) > thresh
        proposals += int(keep.sum())
        if len(gts) == 0:
            continue
        total += len(gts)
        kept = np.asarray(boxes)[keep]
        if len(kept) == 0:
            continue
        # vectorized all-pairs IoU (proposals x GTs) in one shot — the
        # per-GT jit dispatch this replaces was pathological over
        # thousands of images
        ious = _iou_centers_pairwise(kept, np.asarray(gts))
        best = ious.max(axis=0)                      # (n_gt,)
        iou_sum += float(best.sum())
        correct += int((best > iou_thresh).sum())
    return {
        "recall": correct / max(total, 1),
        "avg_iou": iou_sum / max(total, 1),
        "proposals": proposals,
        "total": total,
    }


__all__ = ["voc_ap", "eval_class", "mean_ap", "voc_det_lines",
           "coco_det_records", "proposal_recall", "ClassEval"]


def imagenet_det_lines(image_index: int, boxes: np.ndarray,
                       probs: np.ndarray, img_w: int, img_h: int):
    """ImageNet-det format lines: 'idx cls+1 conf x1 y1 x2 y2'
    (print_imagenet_detections, detector.c:222-242)."""
    out = []
    for i in range(len(boxes)):
        x, y, w, h = boxes[i]
        xmin = max(x * img_w - w * img_w / 2.0 + 1, 1.0)
        ymin = max(y * img_h - h * img_h / 2.0 + 1, 1.0)
        xmax = min(x * img_w + w * img_w / 2.0 + 1, float(img_w))
        ymax = min(y * img_h + h * img_h / 2.0 + 1, float(img_h))
        for j in range(probs.shape[1]):
            if probs[i, j] > 0:
                out.append(f"{image_index} {j + 1} {probs[i, j]:f} "
                           f"{xmin:f} {ymin:f} {xmax:f} {ymax:f}")
    return out
