"""YOLOv2 region-layer training loss, vectorized, gradient-exact.

Counterpart of ``sr_object_detection_tpu/train/region_loss.py``. The
reference computes a hand-written delta field rather than differentiating
a scalar loss (src_yolo2/region_layer.c:177-319): the coord deltas carry
explicit logistic' factors, the objectness delta mixes the noobject,
object and rescore cases, and the class delta (onehot - softmax output)
is backpropagated as if the softmax were the identity. No scalar that
autograd differentiates reproduces that, so :func:`make_region_loss`
injects ``-delta`` through a ``torch.autograd.Function``: the cost is the
reference's printed cost (sum of squared deltas) and its gradient with
respect to the region input is ``-delta`` exactly.

Truth layout matches data.c fill_truth_detection: (B, 30, 5) of
[x, y, w, h, class] relative coords, zero-padded. The WordTree head
(``TreeInfo``, the yolo9000 paths) comes with ROADMAP queue 1, item 4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.spec import RegionSpec
from ..ops.boxes import box_iou


def _truth_mask(truth):
    """Truths are consumed until the first x == 0 (region_layer.c:224
    'if(!truth.x) break') — not just the nonzero entries."""
    return torch.cumprod((truth[..., 0] != 0).to(torch.int32), dim=-1).bool()


def _coord_delta(raw, sig_xy, tgt, anchors, col, row, w, h, scale):
    """delta_region_box for a broadcast target box (B,H,W,A,4)."""
    tx = tgt[..., 0] * w - col
    ty = tgt[..., 1] * h - row
    tw = torch.log(torch.clamp_min(tgt[..., 2], 1e-12) * w / anchors[:, 0])
    th = torch.log(torch.clamp_min(tgt[..., 3], 1e-12) * h / anchors[:, 1])
    return scale * torch.stack([
        (tx - sig_xy[..., 0]) * sig_xy[..., 0] * (1 - sig_xy[..., 0]),
        (ty - sig_xy[..., 1]) * sig_xy[..., 1] * (1 - sig_xy[..., 1]),
        tw - raw[..., 2],
        th - raw[..., 3],
    ], dim=-1)


def _scatter_last(base, b_idx, j_idx, i_idx, n_idx, upd, mask):
    """base (B,H,W,A,K)[b, j, i, n] = upd (B,T,K) for the rows where
    ``mask``; of rows that hit the same cell the last one wins, as the
    reference's sequential loop does. Masked (padding) rows are dropped:
    they must not overwrite a real truth assigned to (0, 0, anchor 0)."""
    _, h, w, a, _ = base.shape
    key = ((b_idx * h + j_idx) * w + i_idx) * a + n_idx
    key = torch.where(mask, key, torch.full_like(key, -1))
    t = key.shape[1]
    later = torch.triu(torch.ones(t, t, dtype=torch.bool,
                                  device=key.device), diagonal=1)
    dup_later = ((key[:, :, None] == key[:, None, :]) & later).any(-1)
    keep = mask & ~dup_later
    # rows that do not write go to a spare last row, which is dropped: no
    # boolean indexing, so the device never waits for the host here
    k = base.shape[-1]
    flat = torch.cat([base.reshape(-1, k), base.new_zeros((1, k))])
    idx = torch.where(keep, key, torch.full_like(key, flat.shape[0] - 1))
    flat[idx.reshape(-1)] = upd.reshape(-1, k).to(flat.dtype)
    return flat[:-1].reshape(base.shape)


def region_delta(raw_flat, truth, seen: int, spec: RegionSpec, *,
                 tree=None, class_map=None):
    """Compute (activated_output_flat, delta_flat, stats).

    raw_flat: (B, H*W*A*F) float32 region-layer input in darknet
    location-major order (the NHWC raster of the preceding conv); delta
    has the same layout and the gradient with respect to the raw input is
    -delta. ``seen`` is the images-seen counter (a Python int)."""
    if tree is not None:
        raise NotImplementedError(
            "the WordTree (yolo9000) region loss is not ported yet (ROADMAP "
            "queue 1, item 4)")
    b = raw_flat.shape[0]
    h, w, a, c = spec.h, spec.w, spec.n, spec.classes
    f = spec.coords + c + 1
    dev = raw_flat.device
    raw = raw_flat.reshape(b, h, w, a, f)
    truth = truth.to(device=dev, dtype=torch.float32)
    anchors = torch.from_numpy(
        np.asarray(spec.anchors, np.float32).reshape(a, 2)).to(dev)

    # ---- forward activations (region_layer.c:144-176) ----------------
    sig_xy = torch.sigmoid(raw[..., 0:2])
    obj = torch.sigmoid(raw[..., 4])
    cls_prob = torch.softmax(raw[..., 5:], dim=-1) if spec.softmax \
        else raw[..., 5:]

    # ---- predicted boxes (get_region_box, DOABS) ---------------------
    col = torch.arange(w, dtype=torch.float32, device=dev).reshape(
        1, 1, w, 1)
    row = torch.arange(h, dtype=torch.float32, device=dev).reshape(
        1, h, 1, 1)
    px = (col + sig_xy[..., 0]) / w
    py = (row + sig_xy[..., 1]) / h
    pw = torch.exp(raw[..., 2]) * anchors[:, 0] / w
    ph = torch.exp(raw[..., 3]) * anchors[:, 1] / h
    pred = torch.stack([px, py, pw, ph], dim=-1)       # (B,H,W,A,4)

    tmask = _truth_mask(truth)                          # (B,T)
    tboxes = truth[..., :4]
    tcls = truth[..., 4].to(torch.int64)

    # ---- stage 1: noobject deltas (region_layer.c:215-242) -----------
    ious = box_iou(pred[:, :, :, :, None, :],
                   tboxes[:, None, None, None, :, :])   # (B,H,W,A,T)
    ious = torch.where(tmask[:, None, None, None, :], ious,
                       torch.zeros_like(ious))
    best_iou = ious.amax(dim=-1)
    sig_grad_obj = obj * (1.0 - obj)
    if spec.classfix == -1:
        d_obj = spec.noobject_scale * (best_iou - obj) * sig_grad_obj
    else:
        d_obj = spec.noobject_scale * (0.0 - obj) * sig_grad_obj
        d_obj = torch.where(best_iou > spec.thresh, torch.zeros_like(d_obj),
                            d_obj)

    # ---- stage 1b: coord warm-up toward anchors (seen < 12800) -------
    shape = pred.shape[:-1]
    if seen < 12800:
        warm_t = torch.stack([
            ((col + 0.5) / w).expand(shape),
            ((row + 0.5) / h).expand(shape),
            (anchors[:, 0] / w).expand(shape),
            (anchors[:, 1] / h).expand(shape)], dim=-1)
        d_coord = _coord_delta(raw, sig_xy, warm_t, anchors, col, row, w, h,
                               0.01)
    else:
        d_coord = torch.zeros_like(pred)

    d_cls = torch.zeros_like(cls_prob)

    # ---- stage 1c: classfix>0 class delta at high-IoU locations ------
    # (region_layer.c:235-240); the RAW truth class, not remapped
    if spec.classfix > 0:
        best_t = ious.argmax(dim=-1)                     # (B,H,W,A)
        bc = torch.gather(tcls[:, None, None, None, :].expand(ious.shape),
                          -1, best_t[..., None])[..., 0]
        fix_scale = spec.class_scale * (
            obj if spec.classfix == 2 else torch.ones_like(obj))
        onehot_f = torch.nn.functional.one_hot(bc, c).to(cls_prob.dtype)
        d_fix = fix_scale[..., None] * (onehot_f - cls_prob)
        d_cls = torch.where((best_iou > spec.thresh)[..., None], d_fix, d_cls)

    # ---- stage 2: per-truth assignment (region_layer.c:259-313) ------
    ti = torch.clamp((tboxes[..., 0] * w).to(torch.int64), 0, w - 1)
    tj = torch.clamp((tboxes[..., 1] * h).to(torch.int64), 0, h - 1)
    bsel = torch.arange(b, device=dev)[:, None]

    cell_raw = raw[bsel, tj, ti]                          # (B,T,A,F)
    cpw = torch.exp(cell_raw[..., 2]) * anchors[:, 0] / w
    cph = torch.exp(cell_raw[..., 3]) * anchors[:, 1] / h
    if spec.bias_match:
        cpw = (anchors[:, 0] / w).expand(cpw.shape)
        cph = (anchors[:, 1] / h).expand(cph.shape)
    zeros = torch.zeros_like(cpw)
    shifted_pred = torch.stack([zeros, zeros, cpw, cph], dim=-1)
    shifted_truth = torch.cat([torch.zeros_like(tboxes[..., 0:2]),
                               tboxes[..., 2:4]], dim=-1)[..., None, :]
    siou = box_iou(shifted_pred, shifted_truth.expand(shifted_pred.shape))
    best_n = siou.argmax(dim=-1)                           # (B,T)

    tsel = torch.arange(truth.shape[1], device=dev)[None, :]
    a_raw = cell_raw[bsel, tsel, best_n]                   # (B,T,F)
    a_sig = torch.sigmoid(a_raw[..., 0:2])
    a_anch = anchors[best_n]                               # (B,T,2)
    tx = tboxes[..., 0] * w - ti
    ty = tboxes[..., 1] * h - tj
    tw = torch.log(torch.clamp_min(tboxes[..., 2] * w, 1e-12) / a_anch[..., 0])
    th = torch.log(torch.clamp_min(tboxes[..., 3] * h, 1e-12) / a_anch[..., 1])
    d_assigned = spec.coord_scale * torch.stack([
        (tx - a_sig[..., 0]) * a_sig[..., 0] * (1 - a_sig[..., 0]),
        (ty - a_sig[..., 1]) * a_sig[..., 1] * (1 - a_sig[..., 1]),
        tw - a_raw[..., 2],
        th - a_raw[..., 3],
    ], dim=-1)

    apx = (ti + a_sig[..., 0]) / w
    apy = (tj + a_sig[..., 1]) / h
    apw = torch.exp(a_raw[..., 2]) * a_anch[..., 0] / w
    aph = torch.exp(a_raw[..., 3]) * a_anch[..., 1] / h
    a_iou = box_iou(torch.stack([apx, apy, apw, aph], dim=-1), tboxes)

    a_obj = torch.sigmoid(a_raw[..., 4])
    if spec.rescore:
        d_obj_assigned = spec.object_scale * (a_iou - a_obj) \
            * a_obj * (1 - a_obj)
    else:
        d_obj_assigned = spec.object_scale * (1.0 - a_obj) \
            * a_obj * (1 - a_obj)

    if class_map is not None:
        tcls = torch.from_numpy(np.asarray(class_map, np.int64)).to(dev)[tcls]
    a_cls_prob = cls_prob[bsel, tj, ti, best_n]            # (B,T,C)
    onehot = torch.nn.functional.one_hot(tcls, c).to(a_cls_prob.dtype)
    d_cls_assigned = spec.class_scale * (onehot - a_cls_prob)

    # ---- scatter the assigned deltas (padding rows dropped) ----------
    bfull = bsel.expand_as(tj)
    d_coord = _scatter_last(d_coord, bfull, tj, ti, best_n, d_assigned,
                            tmask)
    d_obj = _scatter_last(d_obj[..., None], bfull, tj, ti, best_n,
                          d_obj_assigned[..., None], tmask)[..., 0]
    d_cls = _scatter_last(d_cls, bfull, tj, ti, best_n, d_cls_assigned,
                          tmask)

    delta = torch.cat([d_coord, d_obj[..., None], d_cls], dim=-1)
    acts = torch.cat([raw[..., :4], obj[..., None], cls_prob], dim=-1)

    n_t = tmask.sum()
    denom = torch.clamp_min(n_t, 1)
    zero = torch.zeros_like(a_iou)
    stats = {
        "avg_iou": torch.where(tmask, a_iou, zero).sum() / denom,
        "recall": (tmask & (a_iou > 0.5)).sum() / denom,
        "avg_obj": torch.where(tmask, a_obj, zero).sum() / denom,
        "avg_anyobj": obj.mean(),
        "count": n_t,
    }
    return acts.reshape(b, -1), delta.reshape(b, -1), stats


class _DeltaLoss(torch.autograd.Function):
    """cost = sum(delta^2) (region_layer.c:319); gradient -delta * g with
    respect to the region input (darknet deltas are negative gradients)."""

    @staticmethod
    def forward(ctx, raw_flat, delta):
        ctx.save_for_backward(delta)
        return (delta * delta).sum()

    @staticmethod
    def backward(ctx, g):
        delta, = ctx.saved_tensors
        return -delta * g, None


def make_region_loss(spec: RegionSpec, tree=None, class_map=None):
    """Build (loss, loss_with_stats): loss(raw_flat, truth, seen) -> cost
    with the darknet-exact gradient (-delta); loss_with_stats also
    returns region_delta's stats (from the same delta computation)."""
    if tree is not None:
        raise NotImplementedError(
            "the WordTree (yolo9000) region loss is not ported yet (ROADMAP "
            "queue 1, item 4)")

    def loss_with_stats(raw_flat, truth, seen):
        with torch.no_grad():
            _, delta, stats = region_delta(raw_flat.detach(), truth, seen,
                                           spec, class_map=class_map)
        return _DeltaLoss.apply(raw_flat, delta), stats

    def loss(raw_flat, truth, seen):
        return loss_with_stats(raw_flat, truth, seen)[0]

    return loss, loss_with_stats


__all__ = ["region_delta", "make_region_loss"]
