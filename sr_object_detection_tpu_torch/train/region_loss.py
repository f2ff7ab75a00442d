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
[x, y, w, h, class] relative coords, zero-padded.

With a WordTree (the yolo9000 paths, ``TreeInfo``) the class softmax is
grouped by sibling group, the class delta is the hierarchical one
(delta_region_class's tree branch, region_layer.c:108-124), truth ids go
through the map file in stage 2, and truths with x, y > 100000 are
classification-only (region_layer.c:188-213). The class delta treats the
softmax as the identity, so the grouped softmax runs only under
``no_grad`` here and needs no backward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.spec import RegionSpec
from ..ops.boxes import GroupIds, box_iou, grouped_softmax


class TreeInfo:
    """Static per-class tables of the hierarchical class delta: the JAX
    package's ``TreeInfo``, as numpy tables built once and moved to a
    device once (:meth:`on`).

    delta_region_class with a tree walks from the target class to its
    root, writing every sibling group along the path and +1 at each path
    node. ``chain`` (C, D) is each class's ancestor chain, its root
    repeated after the end; ``chain_valid`` marks the new entries;
    ``path_groups`` (C, D) their group ids (-1 on repeats)."""

    def __init__(self, tree, *, max_depth: int = 64):
        parent = np.asarray(tree.parent)
        group = np.asarray(tree.group)
        c = parent.shape[0]
        # forward, self and out-of-range parents occur in truncated tree
        # files; the C walk would spin forever on them. Cut such edges
        # and cap the walk's depth (a real WordTree is ~20 deep).
        idx = np.arange(c)
        parent = np.where((parent >= idx) | (parent < -1), -1, parent)
        chain = [idx]
        cur = parent.copy()
        while (cur >= 0).any() and len(chain) < max_depth:
            chain.append(np.where(cur >= 0, cur, chain[-1]))
            cur = np.where(cur >= 0, parent[np.maximum(cur, 0)], -1)
        self.chain = np.stack(chain, axis=1)              # (C, D)
        valid = np.ones_like(self.chain, dtype=bool)
        valid[:, 1:] = self.chain[:, 1:] != self.chain[:, :-1]
        self.chain_valid = valid
        self.path_groups = np.where(valid, group[self.chain], -1)
        self.group = group
        self.parent = parent
        self.n_groups = int(group.max()) + 1
        self._tables: dict = {}

    def on(self, device):
        """The tables as tensors on ``device`` (moved on first use): chain,
        chain_valid, path_groups with -1 sent to a spare group n_groups,
        each class's group (the same spare for a class with none) and the
        softmax's :class:`GroupIds`."""
        device = torch.device(device)
        key = str(device)
        if key not in self._tables:
            g = self.n_groups

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            self._tables[key] = {
                "chain": t(self.chain.astype(np.int64)),
                "valid": t(self.chain_valid),
                "pgroups": t(np.where(self.path_groups >= 0,
                                      self.path_groups, g).astype(np.int64)),
                "group": t(np.where(self.group >= 0, self.group,
                                    g).astype(np.int64)),
                "softmax": GroupIds(self.group, device)}
        return self._tables[key]

    def class_delta_masks(self, tcls):
        """tcls: (...,) int64 class ids. Returns (pos, grp) bool (..., C):
        pos marks the path's nodes (+1 targets), grp every class in a
        sibling group on the path (the delta's support). Equal to the JAX
        package's masks without their (..., D, C) intermediates: pos is a
        scatter of the D path entries (a repeat hits its node again),
        grp a (..., G) table of the path's groups gathered by each
        class's group."""
        tab = self.on(tcls.device)
        c = self.chain.shape[0]
        lead = tcls.shape
        path = tab["chain"][tcls.reshape(-1)]                # (N, D)
        pos = torch.zeros((path.shape[0], c), dtype=torch.bool,
                          device=tcls.device)
        pos.scatter_(1, path, True)
        marks = torch.zeros((path.shape[0], self.n_groups + 1),
                            dtype=torch.bool, device=tcls.device)
        marks.scatter_(1, tab["pgroups"][tcls.reshape(-1)], True)
        marks[:, -1] = False                                 # the spare
        grp = marks.index_select(1, tab["group"])
        return pos.reshape(*lead, c), grp.reshape(*lead, c)


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
    -delta. ``seen`` is the images-seen counter (a Python int).

    ``tree`` (a :class:`TreeInfo`) and ``class_map`` (a sequence, or an
    int64 tensor already on raw_flat's device) enable the yolo9000 paths
    (the module docstring)."""
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
    if tree is not None:
        cls_prob = grouped_softmax(raw[..., 5:], tree.on(dev)["softmax"])
    elif spec.softmax:
        cls_prob = torch.softmax(raw[..., 5:], dim=-1)
    else:
        cls_prob = raw[..., 5:]

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
        if tree is not None:
            posf, grpf = tree.class_delta_masks(_clamp_ids(bc, c))
            d_fix = torch.where(grpf, fix_scale[..., None] * (
                posf.to(cls_prob.dtype) - cls_prob), 0.0)
            del posf, grpf
        else:
            onehot_f = torch.nn.functional.one_hot(bc, c).to(cls_prob.dtype)
            d_fix = fix_scale[..., None] * (onehot_f - cls_prob)
        d_cls = torch.where((best_iou > spec.thresh)[..., None], d_fix, d_cls)
        del d_fix

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

    raw_tcls = tcls
    if class_map is not None:
        cmap = torch.as_tensor(class_map, dtype=torch.int64, device=dev)
        # a classification-only truth's raw id may lie past the map; its
        # item's deltas are replaced below, and the index is clamped as
        # the JAX gather clamps it
        tcls = cmap[_clamp_ids(tcls, cmap.shape[0]) if tree is not None
                    else tcls]
    a_cls_prob = cls_prob[bsel, tj, ti, best_n]            # (B,T,C)
    if tree is not None:
        pos, grp = tree.class_delta_masks(_clamp_ids(tcls, c))
        d_cls_assigned = torch.where(grp, spec.class_scale * (
            pos.to(a_cls_prob.dtype) - a_cls_prob), 0.0)
        # the tree branch writes only the sibling groups on the path: the
        # rest of the row keeps what stage 1 wrote, merged with the rows
        # as they stood before stage 2 (as the JAX package merges them)
        d_cls_assigned = torch.where(grp, d_cls_assigned,
                                     d_cls[bsel, tj, ti, best_n])
        del pos, grp
    else:
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
    if tree is not None:
        _classification_only(tree, spec, truth, tmask, raw_tcls, obj,
                             cls_prob, d_coord, d_obj, d_cls)

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


def _clamp_ids(ids, n):
    """Class ids clamped into [0, n), as a JAX gather clamps its index."""
    return ids.clamp(0, n - 1)


def _classification_only(tree, spec, truth, tmask, raw_tcls, obj, cls_prob,
                         d_coord, d_obj, d_cls):
    """Classification-only truths (region_layer.c:188-213), in place: a
    truth with x, y > 100000 makes its batch item classification-only.
    At the location with the largest objectness x the path probability
    of the truth's raw class (the first maximum) the item gets the
    hierarchical class delta alone; every other delta of the item is
    zeroed. Branch-free: an item without such a truth keeps its rows."""
    b, h, w, a, c = cls_prob.shape
    dev = cls_prob.device
    tab = tree.on(dev)
    sentinel = (truth[..., 0] > 100000) & (truth[..., 1] > 100000) & tmask
    has = sentinel.any(dim=1)                                # (B,)
    first = sentinel.to(torch.int32).argmax(dim=1)           # (B,)
    ar = torch.arange(b, device=dev)
    s_cls = _clamp_ids(raw_tcls[ar, first], c)               # (B,)
    path, pvalid = tab["chain"][s_cls], tab["valid"][s_cls]  # (B, D)
    flat = cls_prob.reshape(b, h * w * a, c)
    gathered = torch.gather(
        flat, 2, path[:, None, :].expand(b, h * w * a, path.shape[1]))
    path_prob = torch.where(pvalid[:, None, :], gathered, 1.0).prod(dim=-1)
    best = (obj.reshape(b, -1) * path_prob).argmax(dim=1)    # (B,)
    pos, grp = tree.class_delta_masks(s_cls)                 # (B, C)
    cls_at = flat[ar, best]                                  # (B, C)
    d_s = torch.where(grp, spec.class_scale * (pos.to(cls_at.dtype) - cls_at),
                      0.0)
    sel = has[:, None, None, None]
    d_coord.masked_fill_(sel[..., None], 0.0)
    d_obj.masked_fill_(sel, 0.0)
    d_cls.masked_fill_(sel[..., None], 0.0)
    rows = d_cls.view(b, h * w * a, c)
    rows[ar, best] = torch.where(has[:, None], d_s, rows[ar, best])


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
    returns region_delta's stats (from the same delta computation).
    ``tree``: an ``io.tree.WordTree`` or a :class:`TreeInfo`. A profiler
    range ``region_loss`` spans the delta computation."""
    tinfo = None
    if tree is not None:
        tinfo = tree if isinstance(tree, TreeInfo) else TreeInfo(tree)
        if tinfo.chain.shape[0] != spec.classes:
            raise ValueError(f"a tree of {tinfo.chain.shape[0]} nodes for "
                             f"a region head of {spec.classes} classes")

    maps: dict = {}     # the class map on each device, moved once

    def loss_with_stats(raw_flat, truth, seen):
        cmap = None
        if class_map is not None:
            key = str(raw_flat.device)
            if key not in maps:
                maps[key] = torch.as_tensor(np.asarray(class_map, np.int64),
                                            device=raw_flat.device)
            cmap = maps[key]
        with torch.no_grad(), torch.profiler.record_function("region_loss"):
            _, delta, stats = region_delta(raw_flat.detach(), truth, seen,
                                           spec, tree=tinfo, class_map=cmap)
        return _DeltaLoss.apply(raw_flat, delta), stats

    def loss(raw_flat, truth, seen):
        return loss_with_stats(raw_flat, truth, seen)[0]

    return loss, loss_with_stats


__all__ = ["region_delta", "make_region_loss", "TreeInfo"]
