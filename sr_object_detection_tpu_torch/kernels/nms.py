"""Per-class greedy NMS: the CUDA kernel ``csrc/nms.cu`` and its wrapper.

Counterpart of ``sr_object_detection_tpu/kernels/nms_pallas.py``
(``nms_per_class_pallas`` / ``nms_sort_topk_pallas``). The kernel's
design and bound are described in the source. Its plain PyTorch version,
``nms_per_class_plain``, lives in ``ops/boxes.py`` (the port's
``ops.boxes.nms_sort_topk`` runs it too) and is re-exported here.
Exact NMS is :func:`nms_sort_topk` at k = N on either device.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from ..ops import boxes as B
from ..ops.boxes import nms_per_class_plain
from . import _build

launches = 0        # kernel launches since the last reset


def nms_per_class(top_boxes, top_p, iou_thresh: float):
    """top_boxes (C, k, 4) f32 rank-sorted candidates per class, top_p
    (C, k) f32 sorted probs -> suppressed probs (C, k)."""
    global launches
    if top_p.device.type == "cpu":
        return nms_per_class_plain(top_boxes, top_p, iou_thresh)
    c, k = top_p.shape
    if (top_boxes.shape != (c, k, 4) or top_boxes.dtype != torch.float32
            or top_p.dtype != torch.float32
            or top_boxes.device != top_p.device):
        raise ValueError(
            f"nms_per_class: want boxes (C,k,4) and probs (C,k) float32 "
            f"on one device, got {tuple(top_boxes.shape)} "
            f"{top_boxes.dtype} and {tuple(top_p.shape)} {top_p.dtype}")
    lib = _build.load()
    if k > lib.srod_nms_max_k():
        raise ValueError(f"nms_per_class: k={k} exceeds the kernel's "
                         f"limit {lib.srod_nms_max_k()}")
    top_boxes = top_boxes.contiguous()
    top_p = top_p.contiguous()
    out = torch.empty_like(top_p)
    err = lib.srod_nms_per_class(
        top_boxes.data_ptr(), top_p.data_ptr(), out.data_ptr(), c, k,
        float(iou_thresh), _build.stream_ptr(top_p.device))
    _build.check(err, "srod_nms_per_class")
    launches += 1
    return out


def empty_launch(n_classes: int, k: int, device):
    """Launch an empty kernel with :func:`nms_per_class`'s grid, block and
    shared memory for (C, k): the launch floor the NMS kernel is measured
    against (``chip_smoke.py`` phase 1, ``tools/nms_ab.py``). Not counted
    in ``launches``."""
    lib = _build.load()
    _build.check(lib.srod_nms_empty(n_classes, k, _build.stream_ptr(device)),
                 "srod_nms_empty")


def nms_sort_topk(boxes, probs, iou_thresh: float, k: int = 128):
    """Drop-in for ``ops.boxes.nms_sort_topk`` with the per-class core
    going through :func:`nms_per_class`. boxes (N, 4), probs (N, C)."""
    top_boxes, top_p, top_i = B.topk_candidates(boxes, probs, k)
    kept = nms_per_class(top_boxes, top_p, iou_thresh)
    return B.scatter_kept(probs, top_i, kept)


__all__ = ["nms_per_class", "nms_per_class_plain", "nms_sort_topk",
           "empty_launch", "launches"]
