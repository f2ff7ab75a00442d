"""Box math, YOLOv2 region decode, and the plain per-class NMS.

Counterpart of ``sr_object_detection_tpu/ops/boxes.py`` (``box_iou``,
``region_activate`` with the flat softmax, ``decode_region_boxes``,
``region_class_probs``, ``nms_sort_topk``). Boxes are (x, y, w, h)
CENTER format, like the reference (src_yolo2/box.c, region_layer.c).
The WordTree softmax and hierarchy come with the yolo9000 slice (ROADMAP
queue 1, item 4).

``nms_sort_topk`` here is the PLAIN version of the NMS kernel: the CUDA
kernel in ``kernels/nms.py`` computes the same per-class recurrence and
shares this module's candidate selection and scatter.
"""

from __future__ import annotations

import torch


def box_iou(a, b):
    """IoU of two (..., 4) center-format box tensors (box.c:33-58):
    intersection clamped at 0, union = areaA + areaB - inter."""
    ax1 = a[..., 0] - a[..., 2] / 2
    ax2 = a[..., 0] + a[..., 2] / 2
    ay1 = a[..., 1] - a[..., 3] / 2
    ay2 = a[..., 1] + a[..., 3] / 2
    bx1 = b[..., 0] - b[..., 2] / 2
    bx2 = b[..., 0] + b[..., 2] / 2
    by1 = b[..., 1] - b[..., 3] / 2
    by2 = b[..., 1] + b[..., 3] / 2
    iw = torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
    ih = torch.minimum(ay2, by2) - torch.maximum(ay1, by1)
    inter = torch.where((iw < 0) | (ih < 0), torch.zeros_like(iw), iw * ih)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union


def region_activate(raw, n_anchors: int, n_fields: int, *,
                    softmax: bool = False, tree_groups=None):
    """Region layer activations (region_layer.c:144-176).

    raw: NHWC (B, H, W, A*F). Returns (B, H, W, A, F): logistic on the
    objectness slot, softmax over the class slots when ``softmax``; box
    slots stay raw (decode applies logistic/exp)."""
    if tree_groups is not None:
        raise NotImplementedError(
            "the WordTree grouped softmax is not ported yet (ROADMAP "
            "queue 1, item 4)")
    b, h, w, _ = raw.shape
    x = raw.reshape(b, h, w, n_anchors, n_fields)
    obj = torch.sigmoid(x[..., 4:5])
    cls = x[..., 5:]
    if softmax:
        cls = torch.softmax(cls, dim=-1)
    return torch.cat([x[..., :4], obj, cls], dim=-1)


def decode_region_boxes(acts, anchors, *, img_w, img_h):
    """Vectorized get_region_box (region_layer.c:73-85, DOABS=1).

    acts: (B, H, W, A, F) activated region output; anchors: (A, 2).
    Returns boxes (B, H, W, A, 4) scaled by (img_w, img_h)."""
    _, h, w, a, _ = acts.shape
    dev = acts.device
    col = torch.arange(w, device=dev, dtype=torch.float32).reshape(
        1, 1, w, 1)
    row = torch.arange(h, device=dev, dtype=torch.float32).reshape(
        1, h, 1, 1)
    anchors = torch.as_tensor(anchors, dtype=torch.float32).reshape(
        1, 1, 1, a, 2).to(dev)
    bx = (col + torch.sigmoid(acts[..., 0])) / w * img_w
    by = (row + torch.sigmoid(acts[..., 1])) / h * img_h
    bw = torch.exp(acts[..., 2]) * anchors[..., 0] / w * img_w
    bh = torch.exp(acts[..., 3]) * anchors[..., 1] / h * img_h
    return torch.stack([bx, by, bw, bh], dim=-1)


def region_class_probs(acts, *, thresh: float):
    """probs[box, cls] = objectness * class_prob, zeroed at or below
    thresh (get_region_boxes:368-373). acts: (B, H, W, A, F); returns
    (B, H*W*A, C)."""
    probs = acts[..., 4:5] * acts[..., 5:]
    probs = torch.where(probs > thresh, probs, torch.zeros_like(probs))
    return probs.reshape(acts.shape[0], -1, probs.shape[-1])


def topk_candidates(boxes, probs, k: int):
    """Per class, the k highest-prob boxes in rank order.

    boxes (N, 4), probs (N, C) -> (top_boxes (C, k, 4), top_p (C, k),
    top_i (C, k)). Ties rank the lower box index first, as ``lax.top_k``
    does: a stable descending sort, never ``torch.topk``."""
    k = min(k, probs.shape[0])
    top_p, top_i = torch.sort(probs.T, dim=1, descending=True, stable=True)
    top_p = top_p[:, :k].contiguous()
    top_i = top_i[:, :k]
    return boxes[top_i].contiguous(), top_p, top_i


def scatter_kept(probs, top_i, kept):
    """Write the per-class kept probs (C, k) back to (N, C); every box
    outside a class's top k gets 0 for that class."""
    out = torch.zeros_like(probs)
    cls = torch.arange(probs.shape[1], device=probs.device)[:, None]
    out[top_i, cls.expand_as(top_i)] = kept
    return out


def nms_per_class_plain(top_boxes, top_p, iou_thresh: float):
    """Greedy NMS over rank-sorted candidates, all classes at once.

    top_boxes (C, k, 4), top_p (C, k). Rank r survives if its prob > 0
    and no surviving higher rank overlapped it with IoU > thresh
    (strict); a survivor kills every lower rank above the threshold.
    Ranks past the last positive prob can never survive, so the loop
    stops there (same result as running all k)."""
    c, k = top_p.shape
    iou = box_iou(top_boxes[:, :, None, :], top_boxes[:, None, :, :])
    sup = torch.zeros((c, k), dtype=torch.bool, device=top_p.device)
    ranks = torch.arange(k, device=top_p.device)
    pos = (top_p > 0).any(dim=0).nonzero()
    n_live = int(pos[-1]) + 1 if len(pos) else 0
    for r in range(n_live):
        alive = (top_p[:, r] > 0) & ~sup[:, r]
        sup |= alive[:, None] & (iou[:, r, :] > iou_thresh) & (ranks > r)
    return torch.where(sup, torch.zeros_like(top_p), top_p)


def nms_sort_topk(boxes, probs, iou_thresh: float, k: int = 128):
    """NMS over the top-k candidates per class (the production path of
    do_nms_sort, box.c:249-277). boxes (N, 4), probs (N, C) -> new probs
    (N, C)."""
    top_boxes, top_p, top_i = topk_candidates(boxes, probs, k)
    kept = nms_per_class_plain(top_boxes, top_p, iou_thresh)
    return scatter_kept(probs, top_i, kept)


__all__ = [
    "box_iou", "region_activate", "decode_region_boxes",
    "region_class_probs", "topk_candidates", "scatter_kept",
    "nms_per_class_plain", "nms_sort_topk",
]
