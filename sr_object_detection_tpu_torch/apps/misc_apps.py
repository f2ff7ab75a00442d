"""Small demo applications over the shared runtime: this module holds
the YOLOv1 pipelines (yolo.c / coco.c / swag.c) so far.

Counterpart of ``sr_object_detection_tpu/apps/misc_apps.py``. Ported:
``VOC_NAMES``, ``decode_detection_boxes`` and ``fill_truth_region_np``
(numpy, copied as they are) and ``run_yolo_v1``, the v1 training path.
The module's other apps (art, captcha, tag, compare, writing, dice,
voxel, VideoRNN, composite_3d and the rest) come with the next slice
(ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import numpy as np

from ..graph.spec import DetectionSpec


# ---------------------------------------------------------------------------
# YOLOv1 pipelines (yolo.c / coco.c): decode + truth packing
# ---------------------------------------------------------------------------

VOC_NAMES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
             "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
             "motorbike", "person", "pottedplant", "sheep", "sofa",
             "train", "tvmonitor"]


def decode_detection_boxes(output, spec: DetectionSpec):
    """get_detection_boxes (detection_layer.c:224-250): flat v1 output
    -> (boxes (side^2*n, 4) relative, probs (side^2*n, classes))."""
    s2 = spec.side * spec.side
    nc, nb = spec.classes, spec.n
    cls = output[:s2 * nc].reshape(s2, nc)
    obj = output[s2 * nc:s2 * (nc + nb)].reshape(s2, nb)
    raw = output[s2 * (nc + nb):].reshape(s2, nb, 4)
    rows, cols = np.divmod(np.arange(s2), spec.side)
    bx = (raw[..., 0] + cols[:, None]) / spec.side
    by = (raw[..., 1] + rows[:, None]) / spec.side
    pw = raw[..., 2] ** (2 if spec.sqrt else 1)
    ph = raw[..., 3] ** (2 if spec.sqrt else 1)
    boxes = np.stack([bx, by, pw, ph], axis=-1).reshape(-1, 4)
    probs = (obj[..., None] * cls[:, None, :]).reshape(-1, nc)
    return boxes, probs


def fill_truth_region_np(labels: np.ndarray, side: int, classes: int
                         ) -> np.ndarray:
    """YOLOv1 grid truth (data.c fill_truth_region:247-293):
    per cell [is_obj, onehot, cell-rel x, cell-rel y, w, h] — note our
    detection loss consumes [is_obj, onehot, x, y, w, h] with 4 coords.
    labels: (N, 5) [id, x, y, w, h]."""
    truth = np.zeros((side * side, 1 + classes + 4), np.float32)
    for row_ in labels:
        cid, x, y, w, h = row_
        if w < 0.01 or h < 0.01:
            continue
        col = min(int(x * side), side - 1)
        row = min(int(y * side), side - 1)
        idx = col + row * side
        if truth[idx, 0]:
            continue
        truth[idx, 0] = 1
        if int(cid) < classes:
            truth[idx, 1 + int(cid)] = 1
        truth[idx, 1 + classes:] = [x * side - col, y * side - row, w, h]
    return truth


def run_yolo_v1(data_cfg: str, cfg: str, weights, argv, *, device="cuda"):
    """yolo.c / coco.c / swag.c train path: YOLOv1 grid-truth training
    over the float32 Trainer on the detection loss, on ``device``; the
    grid takes the detection layer's class count."""
    import os
    import torch
    from ..config import read_data_cfg
    from ..data.loader import DetectionLoader
    from ..graph.spec import parse_network_cfg
    from ..io import checkpoint as ckpt
    from ..io.weights import load_weights
    from ..train.trainer import Trainer

    options = read_data_cfg(data_cfg)
    train_list = options.get("train", "data/train.list")
    backup_dir = options.get("backup", "backup")
    os.makedirs(backup_dir, exist_ok=True)
    spec = parse_network_cfg(cfg)
    det = spec.layers[-1]
    if not isinstance(det, DetectionSpec):
        raise ValueError(f"{cfg}: v1 training needs a [detection] head")
    params = None
    if weights:
        params, _ = load_weights(spec, weights)
    if torch.device(device).type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    trainer = Trainer(spec, params=params, device=device)
    outer = trainer.outer_batch
    loader = DetectionLoader(train_list, w=spec.net.w, h=spec.net.h,
                             batch=outer, classes=det.classes,
                             jitter=det.jitter, device=device)
    base = os.path.splitext(os.path.basename(cfg))[0]
    max_batches = spec.net.max_batches or 10000
    try:
        while True:
            i = int(trainer.state.seen) // outer + 1
            if i > max_batches:
                break
            x, boxes_truth = loader.next_batch()
            # repack box truths into the v1 grid layout
            grid = np.stack([
                fill_truth_region_np(
                    boxes_truth[b][boxes_truth[b, :, 2] > 0]
                    [:, [4, 0, 1, 2, 3]], det.side, det.classes)
                for b in range(outer)])
            m = trainer.step(x, grid)
            print(f"{i}: {float(m['loss'])/outer:.6f}")
            if ckpt.should_checkpoint(i):
                ckpt.export_weights(
                    ckpt.checkpoint_name(backup_dir, base, i), spec,
                    trainer.state)
    finally:
        loader.close()
    return trainer


__all__ = ["decode_detection_boxes", "fill_truth_region_np", "VOC_NAMES",
           "run_yolo_v1"]
