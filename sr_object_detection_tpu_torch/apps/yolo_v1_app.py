"""YOLOv1 inference/eval modes — test / valid / recall / demo for the
yolo, coco and swag apps (src_yolo2/yolo.c:341-361, coco.c:368-389).

Counterpart of ``sr_object_detection_tpu/apps/yolo_v1_app.py``. The v1
head is a DetectionSpec (detection_layer.c): flat [classes | objectness
| raw boxes] per grid cell, decoded on the host by
``misc_apps.decode_detection_boxes``. The network runs on ``device``
(CUDA unless the CLI's -cpu) in float32, a chunk of images a batch in
``valid``. NMS is exact (k = N = side^2 * num candidates) through
``kernels/nms.nms_sort_topk`` on the detector's device: the CUDA kernel
on the card, its plain version on the CPU. The VOC/COCO writers are
shared with the v2 detector (eval/voc.py). ``COCO_IDS`` and
``_iou_centers`` are the JAX module's, copied as they are.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..graph.compiler import Network
from ..graph.spec import parse_network_cfg, DetectionSpec
from ..io.convert import params_to_torch
from ..io.weights import load_weights, init_params
from ..kernels import nms as NMS
from ..ops.image import load_image_rgb, resize_image_np
from .cli import find_value
from .misc_apps import decode_detection_boxes, VOC_NAMES

# coco.c:17 coco_ids[] — dataset category ids for the 80 classes
COCO_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18,
            19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
            37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52,
            53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70,
            72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87,
            88, 89, 90)



class V1Detector:
    """Detector-shaped wrapper over a DetectionSpec head: preprocess /
    predict_batch / _collect match infer.detector.Detector so
    StreamingDemo drives either; ``nms`` runs exact NMS on ``device``."""

    def __init__(self, cfg: str, weights=None, *, names=None,
                 device="cuda"):
        self.spec = parse_network_cfg(cfg)
        head = self.spec.layers[self.spec.output_layer_index()]
        if not isinstance(head, DetectionSpec):
            raise SystemExit("v1 modes need a [detection] head "
                             "(detection_layer.c); use `detector` for "
                             "[region] models")
        self.head = head
        self.names = list(names) if names else None
        self.tree = None
        self.class_map = None
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from ..infer.detector import disable_tf32
            disable_tf32()
        if weights:
            params, _ = load_weights(self.spec, weights)
        else:
            params = init_params(self.spec)
        self.net = Network(self.spec, params_to_torch(self.spec, params,
                                                      self.device))

    def preprocess(self, img_hwc: np.ndarray) -> np.ndarray:
        # v1 test path plain-resizes like v2 (yolo.c:318 resize_image)
        return resize_image_np(img_hwc, self.spec.net.w, self.spec.net.h)

    @torch.no_grad()
    def forward(self, x) -> np.ndarray:
        """The detection layer's flat output (B, inputs) as numpy."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        out, _ = self.net(x)
        return out.reshape(out.shape[0], -1).cpu().numpy()

    def predict_batch(self, x, thresh: float = 0.0):
        out = self.forward(x)
        bs, ps = [], []
        for row in out:
            b, p = decode_detection_boxes(row, self.head)
            bs.append(b)
            ps.append(p)
        return np.stack(bs), np.stack(ps)

    def nms(self, boxes, probs, iou_thresh: float) -> np.ndarray:
        """Exact do_nms_sort (k = N) of one image's (N, 4) boxes and (N,
        C) probs on the detector's device; the kept probs as numpy."""
        b = torch.as_tensor(boxes, dtype=torch.float32).to(self.device)
        p = torch.as_tensor(probs, dtype=torch.float32).to(self.device)
        return NMS.nms_sort_topk(b, p, iou_thresh,
                                 k=p.shape[0]).cpu().numpy()

    # same collection contract as Detector._collect
    def _collect(self, boxes, probs, thresh):
        from ..infer.detector import Detection
        dets = []
        cls = probs.argmax(axis=1)
        p = probs[np.arange(len(cls)), cls]
        for i in np.nonzero(p > thresh)[0]:
            name = self.names[int(cls[i])] if self.names else None
            dets.append(Detection(box=tuple(float(v) for v in boxes[i]),
                                  class_id=int(cls[i]), prob=float(p[i]),
                                  name=name))
        dets.sort(key=lambda d: -d.prob)
        return dets


def test_yolo_v1(cfg: str, weights, image: str, argv, *, names=None,
                 device="cuda"):
    """test_yolo (yolo.c:290-339) / test_coco (coco.c:295): single
    image, thresh from argv (.2 default), do_nms_sort .4, draw + save
    predictions.ppm."""
    from ..ops.draw import draw_detections
    from .nightmare_app import _save_ppm
    thresh = find_value(argv, "-thresh", 0.2, float)
    out = find_value(argv, "-out", "predictions.ppm")
    det = V1Detector(cfg, weights, names=names or VOC_NAMES, device=device)
    img = load_image_rgb(image)
    t0 = time.time()
    boxes, probs = det.predict_batch(det.preprocess(img)[None])
    probs = np.where(probs[0] > thresh, probs[0], 0.0)
    probs = det.nms(boxes[0], probs, 0.4)
    print(f"{image}: Predicted in {time.time()-t0:f} seconds.")
    dets = det._collect(boxes[0], probs, thresh)
    for d in dets:
        print(f"{d.name or d.class_id}: {100*d.prob:.0f}%")
    _save_ppm(out, draw_detections(img, dets, det.head.classes))
    return dets


def validate_yolo_v1(cfg: str, weights, argv, *, names=None,
                     coco: bool = False, device="cuda"):
    """validate_yolo (yolo.c:116-203) / validate_coco (coco.c:141-232):
    thresh .001, do_nms_sort .5, VOC per-class txt or COCO json
    records; boxes scaled to original pixels and clamped by the
    writers."""
    from ..eval.voc import voc_det_lines, coco_det_records
    list_path = find_value(argv, "-list", "data/voc.2007.test")
    outdir = find_value(argv, "-out", "results")
    prefix = find_value(argv, "-prefix", "comp4_det_test_")
    thresh = find_value(argv, "-thresh", 0.001, float)
    batch = find_value(argv, "-batch", 16, int)
    os.makedirs(outdir, exist_ok=True)
    names = names or VOC_NAMES
    det = V1Detector(cfg, weights, names=names, device=device)
    with open(list_path) as f:
        paths = [l.strip() for l in f if l.strip()]
    if coco:
        fp = open(os.path.join(outdir, "coco_results.json"), "w")
        fp.write("[\n")
        records = []
    else:
        files = {n: open(os.path.join(outdir, f"{prefix}{n}.txt"), "w")
                 for n in names}
    t0 = time.time()
    for off in range(0, len(paths), batch):
        chunk = paths[off:off + batch]
        imgs = [load_image_rgb(p) for p in chunk]
        x = np.stack([det.preprocess(im) for im in imgs])
        boxes, probs = det.predict_batch(x)
        for p, im, b, pr in zip(chunk, imgs, boxes, probs):
            pr = np.where(pr > thresh, pr, 0.0)
            pr = det.nms(b, pr, 0.5)
            ih, iw = im.shape[:2]
            if coco:
                # get_coco_image_id (coco.c:135): digits after the
                # last '_' of the stem
                stem = os.path.splitext(os.path.basename(p))[0]
                image_id = int(stem.rsplit("_", 1)[-1]) \
                    if "_" in stem else int("".join(
                        c for c in stem if c.isdigit()) or 0)
                records += coco_det_records(
                    image_id, b, pr, COCO_IDS[:det.head.classes],
                    iw, ih)
            else:
                stem = os.path.splitext(os.path.basename(p))[0]
                for name, lines in voc_det_lines(stem, b, pr, names,
                                                 iw, ih).items():
                    for line in lines:
                        files[name].write(line + "\n")
        print(f"{min(off+batch, len(paths))}/{len(paths)}",
              file=sys.stderr)
    if coco:
        import json
        fp.write(",\n".join(json.dumps(r) for r in records) + "\n]\n")
        fp.close()
    else:
        for f in files.values():
            f.close()
    print(f"Total Detection Time: {time.time()-t0:f} Seconds",
          file=sys.stderr)


def validate_yolo_v1_recall(cfg: str, weights, argv, *, device="cuda"):
    """validate_yolo_recall (yolo.c:204-288) / coco recall: proposals
    from the OBJECTNESS channel only (get_detection_boxes
    only_objectness=1), no NMS, running RPs/IOU/Recall lines."""
    from ..data.loader import read_boxes, label_path_for
    list_path = find_value(argv, "-list", "data/voc.2007.test")
    thresh = find_value(argv, "-thresh", 0.001, float)
    iou_thresh = find_value(argv, "-iou", 0.5, float)
    det = V1Detector(cfg, weights, device=device)
    with open(list_path) as f:
        paths = [l.strip() for l in f if l.strip()]
    total = correct = proposals = 0
    avg_iou = 0.0
    s2 = det.head.side ** 2
    nc, nb = det.head.classes, det.head.n
    for i, path in enumerate(paths):
        img = load_image_rgb(path)
        out = det.forward(det.preprocess(img)[None]).reshape(-1)
        boxes, _ = decode_detection_boxes(out, det.head)
        # only_objectness (detection_layer.c:245-247): proposals score
        # by the raw objectness channel, not class products
        obj = out[s2 * nc:s2 * (nc + nb)].reshape(-1)
        proposals += int((obj > thresh).sum())
        labels = read_boxes(label_path_for(path))
        gt = labels[:, 1:5] if len(labels) else np.zeros((0, 4))
        for t in gt:
            total += 1
            mask = obj > thresh
            if mask.any():
                ious = _iou_centers(boxes[mask], t)
                best = float(ious.max())
            else:
                best = 0.0
            avg_iou += best
            if best > iou_thresh:
                correct += 1
        print(f"{i:5d} {correct:5d} {total:5d}\t"
              f"RPs/Img: {proposals/(i+1):.2f}\t"
              f"IOU: {100*avg_iou/max(total,1):.2f}%\t"
              f"Recall:{100*correct/max(total,1):.2f}%")
    return {"proposals": proposals, "correct": correct, "total": total,
            "avg_iou": avg_iou / max(total, 1)}


def _iou_centers(boxes: np.ndarray, t: np.ndarray) -> np.ndarray:
    """box_iou (box.c) on center-format boxes, vectorized."""
    bx1 = boxes[:, 0] - boxes[:, 2] / 2
    bx2 = boxes[:, 0] + boxes[:, 2] / 2
    by1 = boxes[:, 1] - boxes[:, 3] / 2
    by2 = boxes[:, 1] + boxes[:, 3] / 2
    tx1, tx2 = t[0] - t[2] / 2, t[0] + t[2] / 2
    ty1, ty2 = t[1] - t[3] / 2, t[1] + t[3] / 2
    iw = np.maximum(np.minimum(bx2, tx2) - np.maximum(bx1, tx1), 0)
    ih = np.maximum(np.minimum(by2, ty2) - np.maximum(by1, ty1), 0)
    inter = iw * ih
    union = boxes[:, 2] * boxes[:, 3] + t[2] * t[3] - inter
    return inter / np.maximum(union, 1e-12)


def demo_yolo_v1(cfg: str, weights, argv, *, names=None, device="cuda"):
    """yolo/coco demo (yolo.c:360, coco.c:388): the shared demo.c
    pipeline over a v1 head — fetch/detect overlap + 3-frame
    smoothing via StreamingDemo."""
    from ..robot.frame_source import (ImageDirectorySource,
                                      VideoFileSource)
    from .demo_app import StreamingDemo
    video = find_value(argv, "-video", None)
    pattern = find_value(argv, "-frames", "frames/*.ppm")
    thresh = find_value(argv, "-thresh", 0.2, float)
    det = V1Detector(cfg, weights, names=names or VOC_NAMES, device=device)
    source = (VideoFileSource(video) if video
              else ImageDirectorySource(pattern))
    demo = StreamingDemo(det, source, thresh=thresh)

    def show(r):
        labels = ", ".join(f"{d.name or d.class_id}:{d.prob:.2f}"
                           for d in r["detections"])
        print(f"FPS:{r['fps']:.1f}  {labels}")

    return demo.run(on_result=show)


__all__ = ["V1Detector", "test_yolo_v1", "validate_yolo_v1",
           "validate_yolo_v1_recall", "demo_yolo_v1", "COCO_IDS"]
