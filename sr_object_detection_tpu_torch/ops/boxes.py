"""Box math, YOLOv2 region decode, and the plain per-class NMS.

Counterpart of ``sr_object_detection_tpu/ops/boxes.py`` (``box_iou``,
``region_activate`` with the flat and the WordTree softmax, its aligned
and pre-split forms, ``grouped_softmax``, ``hierarchy_multiply``,
``decode_region_boxes``, ``region_class_probs``, ``nms_sort_topk``).
Boxes are (x, y, w, h) CENTER format, like the reference
(src_yolo2/box.c, region_layer.c).

``grouped_softmax`` is one plain form for every group-id array: the JAX
module's band matmuls (contiguous ids), padded buckets and segment
scatter were TPU lowerings of the same function (ROADMAP "Not ported").

``nms_sort_topk`` and ``nms_sort_exact`` here are the PLAIN versions of
the NMS kernel: the CUDA kernel in ``kernels/nms.py`` computes the same
per-class recurrence and shares this module's candidate selection and
scatter.
"""

from __future__ import annotations

import numpy as np
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


def iou_matrix(boxes):
    """All-pairs IoU for (N, 4) center boxes -> (N, N)."""
    return box_iou(boxes[:, None, :], boxes[None, :, :])


def _class_softmax(cls, softmax: bool, tree_groups):
    if tree_groups is not None:
        return grouped_softmax(cls, tree_groups)
    if softmax:
        return torch.softmax(cls, dim=-1)
    return cls


def region_activate(raw, n_anchors: int, n_fields: int, *,
                    softmax: bool = False, tree_groups=None):
    """Region layer activations (region_layer.c:144-176).

    raw: NHWC (B, H, W, A*F). Returns (B, H, W, A, F): logistic on the
    objectness slot, softmax (flat, or grouped by ``tree_groups``, a
    WordTree's sibling groups as :class:`GroupIds`) over the class slots;
    box slots stay raw (decode applies logistic/exp)."""
    b, h, w, _ = raw.shape
    x = raw.reshape(b, h, w, n_anchors, n_fields)
    obj = torch.sigmoid(x[..., 4:5])
    cls = _class_softmax(x[..., 5:], softmax, tree_groups)
    return torch.cat([x[..., :4], obj, cls], dim=-1)


def region_activate_aligned(raw, n_anchors: int, coords: int,
                            classes: int, block: int, *,
                            softmax: bool = False, tree_groups=None):
    """:func:`region_activate` on the aligned head layout
    (``infer.engine.align_region_head``): raw is (B, H, W, A*block) with
    per-anchor channels [coords+1 fields | pad to 128 | classes | pad].
    Returns the same (B, H, W, A, F) darknet field order."""
    b, h, w, _ = raw.shape
    x = raw.reshape(b, h, w, n_anchors, block)
    obj = torch.sigmoid(x[..., coords:coords + 1])
    cls = _class_softmax(x[..., 128:128 + classes], softmax, tree_groups)
    return torch.cat([x[..., :coords], obj, cls], dim=-1)


def region_activate_split(raw, n_anchors: int, coords: int,
                          classes: int, block: int, *,
                          softmax: bool = False, tree_groups=None):
    """Pre-split region activation on the aligned head layout: the
    darknet field order is never reassembled. Returns

      fields: (B, H, W, A, coords+1) raw box slots + logistic obj
      cls:    (B, H, W, A, classes) softmaxed class probabilities

    ``torch.cat([fields, cls], -1)`` is :func:`region_activate`'s
    output."""
    b, h, w, _ = raw.shape
    x = raw.reshape(b, h, w, n_anchors, block)
    obj = torch.sigmoid(x[..., coords:coords + 1])
    fields = torch.cat([x[..., :coords], obj], dim=-1)
    cls = _class_softmax(x[..., 128:128 + classes], softmax, tree_groups)
    return fields, cls


def flat_head_gids(n_anchors: int, coords: int, classes: int, block: int,
                   base_gids):
    """Group ids and additive mask for the flat aligned head row (A*block
    lanes), the JAX module's ``_flat_head_gids``: each anchor contributes
    [fields + pad | classes | tail pad]; the junk lanes get groups of
    their own (masked to -1e9, they normalize among themselves), the
    class lanes the groups of ``base_gids`` (one group when None), each
    anchor's after the last. Returns (ext int64 (A*block,), mask float32
    (A*block,)) in numpy."""
    g0 = (np.zeros(classes, np.int64) if base_gids is None
          else np.asarray(base_gids, np.int64))
    ng = int(g0.max()) + 1
    total = n_anchors * block
    ext = np.zeros(total, np.int64)
    mask = np.full(total, -1e9, np.float32)
    nxt = 0
    tail = block - 128 - classes
    for a in range(n_anchors):
        o = a * block
        ext[o:o + 128] = nxt
        nxt += 1
        ext[o + 128:o + 128 + classes] = nxt + g0
        mask[o + 128:o + 128 + classes] = 0.0
        nxt += ng
        if tail > 0:
            ext[o + 128 + classes:o + block] = nxt
            nxt += 1
    return ext, mask


def region_activate_split_flat(raw, n_anchors: int, coords: int,
                               block: int, *, flat_gids):
    """Pre-split region activation that keeps the class tensor flat in
    the head conv's own layout. Returns

      fields:   (B, H, W, A, coords+1) raw box slots + logistic obj
      cls_flat: (B, H, W, A*block): class probs at
                [a*block+128 : a*block+128+classes] for anchor a; every
                other lane is junk that the consumer slices away.

    ``flat_gids``: :func:`flat_head_gids`' (ext, mask) pair as
    (:class:`GroupIds`, mask tensor) on raw's device, built once by the
    caller; None for a head without a class softmax (raw passes
    through). The mask is added in raw's dtype (so in bf16 it is
    rounded), and the softmax runs over the extended groups with the
    whole row's max as the shared offset."""
    f = coords + 1
    fields = torch.stack([raw[..., a * block:a * block + f]
                          for a in range(n_anchors)], dim=3)
    obj = torch.sigmoid(fields[..., coords:coords + 1])
    fields = torch.cat([fields[..., :coords], obj], dim=-1)
    if flat_gids is None:
        return fields, raw
    ext, mask = flat_gids
    return fields, grouped_softmax(raw + mask.to(raw.dtype), ext)


class GroupIds:
    """Group ids (a numpy array or list) on a device with their group
    count: what a layer builds once at construction, so that no forward
    reads ids back from the card."""

    def __init__(self, group_ids, device):
        ids = np.asarray(group_ids, np.int64)
        self.n_groups = int(ids.max()) + 1
        self.ids = torch.from_numpy(ids).to(device)


def grouped_softmax(logits, group_ids):
    """Segmented softmax over the last axis (softmax_tree semantics,
    tree.c:53-103): ``group_ids`` maps each of the C classes to its
    sibling group, as :class:`GroupIds` on logits' device (built once by
    the caller).

    The shared offset is the row's max, as in the JAX module's matmul
    form (``_grouped_softmax_matmul``): softmax within a group is exact
    for any per-row offset, and the clamp of x - max at -80 keeps a
    group far below the row max from 0/0. The per-group sums are an
    index-add over the class axis in float32, gathered back by group id.
    It rounds where the JAX form does: x - max in logits' dtype, e = exp
    in float32 rounded to the dtype (and summed as rounded), the
    reciprocal of the sums rounded to the dtype, and the product of the
    float32 e and that reciprocal rounded to the dtype. Gapped or
    non-contiguous ids stay finite: an empty group's sum is 0, but no
    class gathers it. A profiler range of the same name shows its device
    time in a trace. Logits that require a gradient (a training forward)
    take the exp and the product out of place, so that autograd gives
    the full Jacobian."""
    gid = group_ids.ids
    grad = logits.requires_grad
    with torch.profiler.record_function("grouped_softmax"):
        dt = logits.dtype
        vmax = logits.max(dim=-1, keepdim=True).values
        e32 = (logits - vmax).float()
        # autograd keeps exp's output for its backward: nothing after it
        # may overwrite it
        e32 = e32.clamp(min=-80.0).exp() if grad else \
            e32.clamp_(min=-80.0).exp_()
        e = e32.to(dt)
        gsum = torch.zeros((*logits.shape[:-1], group_ids.n_groups),
                           dtype=torch.float32, device=logits.device)
        gsum.index_add_(-1, gid, e.float())
        del e
        inv = gsum.reciprocal_().to(dt).index_select(-1, gid).float()
        return (e32 * inv if grad else e32.mul_(inv)).to(dt)


def hierarchy_chain(parents, device=None):
    """The static ancestor-chain table of :func:`hierarchy_multiply`:
    (chain int64 (C, depth), valid bool (C, depth)) tensors on
    ``device``. chain[c] walks c, parent(c), ... to its root and repeats
    the root; valid marks the strictly new entries. Built once per tree
    (parents precede children in a tree file)."""
    parents = np.asarray(parents)
    c = parents.shape[0]
    chain = [np.arange(c)]
    cur = parents.copy()
    while (cur >= 0).any():
        chain.append(np.where(cur >= 0, cur, chain[-1]))
        cur = np.where(cur >= 0, parents[np.maximum(cur, 0)], -1)
    chain = np.stack(chain, axis=1)
    valid = np.ones_like(chain, dtype=bool)
    valid[:, 1:] = chain[:, 1:] != chain[:, :-1]
    return (torch.from_numpy(chain.astype(np.int64)).to(device),
            torch.from_numpy(valid).to(device))


def hierarchy_multiply(probs, chain):
    """hierarchy_predictions (tree.c:37-51): each class's prob times its
    ancestors', i.e. the product along its path to the root.

    probs (..., C); ``chain``: the (chain, valid) pair of
    :func:`hierarchy_chain` on probs' device, built once. Returns the
    path products (..., C)."""
    chain, valid = chain
    gathered = probs[..., chain]                      # (..., C, depth)
    gathered = torch.where(valid, gathered, torch.ones_like(gathered))
    return gathered.prod(dim=-1)


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


# The plain NMS suppresses at most this many bytes of (classes, k, k)
# float32 IoUs at once; tests lower it to exercise the class chunks.
NMS_PLAIN_CHUNK_BYTES = 1 << 28


def _nms_rows(top_boxes, top_p, iou_thresh: float):
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


def nms_per_class_plain(top_boxes, top_p, iou_thresh: float):
    """Greedy NMS over rank-sorted candidates, all classes at once.

    top_boxes (C, k, 4), top_p (C, k). Rank r survives if its prob > 0
    and no surviving higher rank overlapped it with IoU > thresh
    (strict); a survivor kills every lower rank above the threshold.
    Ranks past the last positive prob can never survive, so the loop
    stops there (same result as running all k). A class with no
    positive prob passes through as it is; the others are suppressed in
    chunks of at most ``NMS_PLAIN_CHUNK_BYTES`` of IoUs, so memory stays
    O(k^2 + k*C) for any class count (one (C, k, k) tensor would take
    9.7 GB at yolo9000's 9,418 classes and k = 507)."""
    c, k = top_p.shape
    out = top_p.clone()
    live = (top_p > 0).any(dim=1).nonzero().flatten()
    step = max(1, NMS_PLAIN_CHUNK_BYTES // max(1, 4 * k * k))
    for s in range(0, len(live), step):
        rows = live[s:s + step]
        out[rows] = _nms_rows(top_boxes[rows], top_p[rows], iou_thresh)
    return out


def nms_sort_topk(boxes, probs, iou_thresh: float, k: int = 128):
    """NMS over the top-k candidates per class (the production path of
    do_nms_sort, box.c:249-277). boxes (N, 4), probs (N, C) -> new probs
    (N, C). At k = N it is the exact do_nms_sort: each class's
    candidates in rank order, ties by box index as a stable argsort of
    -p ranks them."""
    top_boxes, top_p, top_i = topk_candidates(boxes, probs, k)
    kept = nms_per_class_plain(top_boxes, top_p, iou_thresh)
    return scatter_kept(probs, top_i, kept)


def nms_sort_exact(boxes, probs, iou_thresh: float):
    """Exact do_nms_sort over every rank: :func:`nms_sort_topk` at
    k = N."""
    return nms_sort_topk(boxes, probs, iou_thresh, k=probs.shape[0])


def nms_sort(boxes, probs, iou_thresh: float):
    """Per-class greedy NMS over all N ranks: the same function as
    :func:`nms_sort_exact`."""
    return nms_sort_exact(boxes, probs, iou_thresh)


__all__ = [
    "box_iou", "iou_matrix", "region_activate", "region_activate_aligned",
    "region_activate_split", "region_activate_split_flat",
    "flat_head_gids", "grouped_softmax", "GroupIds",
    "hierarchy_chain", "hierarchy_multiply", "decode_region_boxes",
    "region_class_probs", "topk_candidates", "scatter_kept",
    "NMS_PLAIN_CHUNK_BYTES", "nms_per_class_plain", "nms_sort_topk",
    "nms_sort_exact", "nms_sort",
]
