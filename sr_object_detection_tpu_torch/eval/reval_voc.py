"""Re-evaluate saved detections -> per-class AP + mAP (the analog of
scripts/reval_voc.py + voc_eval.py in the reference): reads the
comp4_det_test_<class>.txt files `detector valid` / `yolo valid` write
and scores them against ground truth.

Ground truth comes from either
  * --annotations <dir> of VOC XML files (<stem>.xml, the reference's
    path), or
  * --labels <dir> of darknet txt label files (<stem>.txt with
    `id cx cy w h` relative rows) plus --image-list to recover image
    sizes.

  python -m sr_object_detection_tpu_torch.eval.reval_voc results/ \\
      --classes voc.names --labels VOC/labels \\
      --image-list 2007_test.txt [--use-07]

The port's copy of ``tools/reval_voc.py``: the same code, scoring with
the port's ``eval.voc.mean_ap`` and reading image sizes with its
``ops.image.load_image_u8``, so it runs where JAX is not installed.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np


def read_det_file(path: str):
    """comp4 format: image_id conf x1 y1 x2 y2 (pixel corners)."""
    dets = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 6:
                dets.append((parts[0], float(parts[1]),
                             *(float(v) for v in parts[2:])))
    return dets


def gt_from_xml(ann_dir: str, classes):
    per_cls = {c: {} for c in classes}
    for fn in glob.glob(os.path.join(ann_dir, "*.xml")):
        stem = os.path.splitext(os.path.basename(fn))[0]
        text = open(fn).read()
        for m in re.finditer(
                r"<object>.*?<name>([^<]*)</name>.*?"
                r"<xmin>([\d.]+)</xmin>.*?<ymin>([\d.]+)</ymin>.*?"
                r"<xmax>([\d.]+)</xmax>.*?<ymax>([\d.]+)</ymax>.*?"
                r"</object>", text, re.S):
            name = m.group(1)
            if name not in per_cls:
                continue
            diff = "<difficult>1</difficult>" in m.group(0)
            box = [float(m.group(i)) for i in (2, 3, 4, 5)]
            e = per_cls[name].setdefault(stem,
                                         {"boxes": [], "difficult": []})
            e["boxes"].append(box)
            e["difficult"].append(diff)
    return per_cls


def gt_from_labels(label_dir: str, image_list: str, classes):
    from sr_object_detection_tpu_torch.ops.image import load_image_u8
    per_cls = {c: {} for c in classes}
    with open(image_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        lab = os.path.join(label_dir, stem + ".txt")
        if not os.path.exists(lab):
            continue
        ih, iw = load_image_u8(p).shape[:2]
        with open(lab) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                cid = int(parts[0])
                if cid >= len(classes):
                    continue
                cx, cy, w, h = (float(v) for v in parts[1:5])
                box = [(cx - w / 2) * iw, (cy - h / 2) * ih,
                       (cx + w / 2) * iw, (cy + h / 2) * ih]
                e = per_cls[classes[cid]].setdefault(
                    stem, {"boxes": [], "difficult": []})
                e["boxes"].append(box)
                e["difficult"].append(False)
    return per_cls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("results_dir")
    ap.add_argument("--classes", required=True,
                    help="names file (one class per line)")
    ap.add_argument("--prefix", default="comp4_det_test_")
    ap.add_argument("--annotations", help="VOC XML dir")
    ap.add_argument("--labels", help="darknet txt label dir")
    ap.add_argument("--image-list", help="image list (with --labels)")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--use-07", action="store_true",
                    help="11-point metric (voc_eval.py:31-47)")
    args = ap.parse_args(argv)

    from sr_object_detection_tpu_torch.eval.voc import mean_ap
    with open(args.classes) as f:
        classes = [l.strip() for l in f if l.strip()]
    if args.annotations:
        gt = gt_from_xml(args.annotations, classes)
    elif args.labels and args.image_list:
        gt = gt_from_labels(args.labels, args.image_list, classes)
    else:
        ap.error("need --annotations or (--labels and --image-list)")
    dets = {}
    for c in classes:
        p = os.path.join(args.results_dir, f"{args.prefix}{c}.txt")
        dets[c] = read_det_file(p) if os.path.exists(p) else []
    m, aps = mean_ap(dets, gt, iou_thresh=args.iou,
                     use_07_metric=args.use_07)
    for c in classes:
        print(f"AP for {c} = {aps.get(c, 0.0):.4f}")
    print(f"Mean AP = {m:.4f}")
    return m


if __name__ == "__main__":
    main()
