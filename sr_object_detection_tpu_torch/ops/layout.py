"""Flat <-> NHWC conversions in darknet's CHW raster order.

Counterpart of ``nhwc_to_flat`` / ``flat_to_nhwc`` in
``sr_object_detection_tpu/ops/layout.py``. route, reorg and shortcut come
with the yolov2 slice (ROADMAP queue 1, item 2).
"""

from __future__ import annotations


def nhwc_to_flat(x):
    """Flatten NHWC -> (B, C*H*W) in darknet CHW raster order."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def flat_to_nhwc(x, h: int, w: int, c: int):
    """Inverse of :func:`nhwc_to_flat`."""
    return x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1)


__all__ = ["nhwc_to_flat", "flat_to_nhwc"]
