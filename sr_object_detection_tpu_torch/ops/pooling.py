"""Darknet maxpool, NCHW inside.

Counterpart of ``sr_object_detection_tpu/ops/pooling.py:maxpool``
(maxpool_layer.c:21-114): out = (in + 2*pad)//stride, the window anchored
at -pad, every out-of-bounds tap reading -FLT_MAX. The right/bottom
overhang is padded with -inf explicitly: tiny-yolo's layer 11 (size 2,
stride 1, pad 0 on 13x13) has a last window that overhangs by one, which
``F.max_pool2d``'s symmetric padding cannot express. avgpool and lrn come
with the classifier and lrn slices (ROADMAP queue 1, item 2).

:func:`maxpool_i8` is the int8 serving path's pool (the JAX package's
``infer.quant._maxpool_q``) on NHWC int8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool(x, *, size: int, stride: int, pad: int, pad_value=None):
    """Darknet maxpool on NCHW x. ``pad_value`` replaces the -inf pad
    identity (the int8 path pads with iinfo(int8).min)."""
    h, w = x.shape[2], x.shape[3]
    out_h = (h + 2 * pad) // stride
    out_w = (w + 2 * pad) // stride
    pad_b = max(0, (out_h - 1) * stride + size - h - pad)
    pad_r = max(0, (out_w - 1) * stride + size - w - pad)
    if pad or pad_b or pad_r:
        x = F.pad(x, (pad, pad_r, pad, pad_b),
                  value=float("-inf") if pad_value is None else pad_value)
    y = F.max_pool2d(x, kernel_size=size, stride=stride)
    return y[:, :, :out_h, :out_w]


def maxpool_i8(x_q, *, size: int, stride: int, pad: int):
    """Darknet maxpool on NHWC int8, padded with iinfo(int8).min (-inf
    has no int8 code). ``F.max_pool2d`` takes no int8, so it pools a
    bf16 copy: every int8 value is exact in bf16, so max and the cast
    back are exact."""
    y = maxpool(x_q.permute(0, 3, 1, 2).to(torch.bfloat16), size=size,
                stride=stride, pad=pad,
                pad_value=float(torch.iinfo(torch.int8).min))
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


__all__ = ["maxpool", "maxpool_i8"]
