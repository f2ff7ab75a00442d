"""Darknet maxpool, NCHW inside.

Counterpart of ``sr_object_detection_tpu/ops/pooling.py:maxpool``
(maxpool_layer.c:21-114): out = (in + 2*pad)//stride, the window anchored
at -pad, every out-of-bounds tap reading -FLT_MAX. The right/bottom
overhang is padded with -inf explicitly: tiny-yolo's layer 11 (size 2,
stride 1, pad 0 on 13x13) has a last window that overhangs by one, which
``F.max_pool2d``'s symmetric padding cannot express. avgpool and lrn come
with the classifier and lrn slices (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

import torch.nn.functional as F


def maxpool(x, *, size: int, stride: int, pad: int):
    """Darknet maxpool on NCHW x."""
    h, w = x.shape[2], x.shape[3]
    out_h = (h + 2 * pad) // stride
    out_w = (w + 2 * pad) // stride
    pad_b = max(0, (out_h - 1) * stride + size - h - pad)
    pad_r = max(0, (out_w - 1) * stride + size - w - pad)
    if pad or pad_b or pad_r:
        x = F.pad(x, (pad, pad_r, pad, pad_b), value=float("-inf"))
    y = F.max_pool2d(x, kernel_size=size, stride=stride)
    return y[:, :, :out_h, :out_w]


__all__ = ["maxpool"]
