"""YOLOv1 detection-layer loss, vectorized, gradient-exact.

Counterpart of ``sr_object_detection_tpu/train/detection_loss.py``.
Reference: forward_detection_layer's train path
(src_yolo2/detection_layer.c:49-217). The reference writes a delta field
(deltas are NEGATIVE gradients; backward just axpys them, :218-222), so
the same field is computed here, vectorized, and handed to autograd by a
``torch.autograd.Function`` whose backward is -delta * g (the JAX
module's ``custom_vjp``).

Layouts (flat per batch row of the output):
  [side^2 * classes class probs][side^2 * n objectness]
  [side^2 * n * coords boxes]
Truth per cell (side^2 cells x (1+classes+4)):
  [is_obj][class one-hot...][x, y, w, h] with x,y in CELL units
  (forward divides by side: :104-106).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.spec import DetectionSpec
from ..ops.boxes import box_iou


def _div_xy(b, side: int):
    """Boxes with x and y divided by ``side`` (the cell-unit centres to
    image units), the other coords as they are."""
    return torch.cat([b[..., :2] / side, b[..., 2:]], dim=-1)


def _square_wh(b):
    return torch.cat([b[..., :2], b[..., 2:4].square(), b[..., 4:]], dim=-1)


def detection_delta(output, truth, spec: DetectionSpec):
    """output: (B, inputs) post-softmax detection layer output.
    truth: (B, side^2, 1+classes+4). Returns delta (B, inputs)."""
    b = output.shape[0]
    s2 = spec.side * spec.side
    nc, nb, co = spec.classes, spec.n, spec.coords

    cls = output[:, :s2 * nc].reshape(b, s2, nc)
    obj = output[:, s2 * nc:s2 * (nc + nb)].reshape(b, s2, nb)
    boxes = output[:, s2 * (nc + nb):].reshape(b, s2, nb, co)

    is_obj = truth[..., 0] > 0                        # (B, s2)
    t_cls = truth[..., 1:1 + nc]                      # (B, s2, C)
    t_box = truth[..., 1 + nc:1 + nc + 4]             # (B, s2, 4)

    # ---- objectness: noobject everywhere (:80-86) --------------------
    d_obj = spec.noobject_scale * (0.0 - obj)

    # ---- class deltas at object cells (:96-102) ----------------------
    d_cls = torch.where(is_obj[..., None], spec.class_scale * (t_cls - cls),
                        0.0)

    # ---- best box by IoU (rmse fallback) (:104-131) -------------------
    tb = _div_xy(t_box, spec.side)
    ob = _div_xy(boxes, spec.side)
    if spec.sqrt:
        ob = _square_wh(ob)
    ious = box_iou(ob, tb[..., None, :])              # (B, s2, nb)
    rmse = torch.sqrt((ob - tb[..., None, :]).square().sum(dim=-1))
    any_iou = (ious > 0).any(dim=-1, keepdim=True)
    score = torch.where(any_iou, ious, -rmse)
    # the first index on ties, as jnp.argmax
    best = torch.argmax(score, dim=-1)                # (B, s2)
    if spec.forced:
        small = (tb[..., 2] * tb[..., 3]) < 0.1
        best = small.long()

    onehot_b = F.one_hot(best, nb).to(output.dtype)   # (B, s2, nb)
    sel = onehot_b[..., None]                         # (B, s2, nb, 1)

    best_obj = (obj * onehot_b).sum(dim=-1)           # (B, s2)
    best_iou = (ious * onehot_b).sum(dim=-1)
    if spec.rescore:
        d_obj_sel = spec.object_scale * (best_iou - best_obj)
    else:
        d_obj_sel = spec.object_scale * (1.0 - best_obj)
    d_obj = torch.where(is_obj[..., None] & (onehot_b > 0),
                        d_obj_sel[..., None], d_obj)

    # ---- coord deltas at the selected box (:166-174) ------------------
    tgt = t_box
    if spec.sqrt:
        tgt = torch.cat([tgt[..., :2], tgt[..., 2:4].clamp_min(0).sqrt()],
                        dim=-1)
    d_box = spec.coord_scale * (tgt[..., None, :] - boxes)
    d_box = torch.where(is_obj[..., None, None] & (sel > 0), d_box, 0.0)

    return torch.cat([d_cls.reshape(b, -1), d_obj.reshape(b, -1),
                      d_box.reshape(b, -1)], dim=1)


class _DetectionLoss(torch.autograd.Function):
    """sum(delta^2) forward (*(l.cost) = mag(delta)^2, :205), -delta * g
    backward to the output; no gradient to the truth."""

    @staticmethod
    def forward(ctx, output, truth, spec):
        d = detection_delta(output, truth, spec)
        ctx.save_for_backward(d)
        return d.square().sum()

    @staticmethod
    def backward(ctx, g):
        d, = ctx.saved_tensors
        return -d * g, None, None


def detection_loss(output, truth, spec: DetectionSpec):
    """The YOLOv1 cost of ``output`` (B, inputs) float32 against the grid
    ``truth``; its gradient is -delta."""
    return _DetectionLoss.apply(output, truth, spec)


__all__ = ["detection_delta", "detection_loss"]
