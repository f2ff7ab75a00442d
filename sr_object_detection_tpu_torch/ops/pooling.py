"""Darknet maxpool, NCHW inside.

Counterpart of ``sr_object_detection_tpu/ops/pooling.py:maxpool``
(maxpool_layer.c:21-114): out = (in + 2*pad)//stride, the window anchored
at -pad, every out-of-bounds tap reading -FLT_MAX. The right/bottom
overhang is padded with -inf explicitly: tiny-yolo's layer 11 (size 2,
stride 1, pad 0 on 13x13) has a last window that overhangs by one, which
``F.max_pool2d``'s symmetric padding cannot express. The JAX
package's ``train_mode="amax"`` (a first-max-rank residual, measured a
loss there) is not ported.

:func:`avgpool_global` and :func:`lrn` are the classifier layers' pools
(the JAX module's functions of the same names), on NCHW.

:func:`maxpool_i8` is the int8 serving path's pool (the JAX package's
``infer.quant._maxpool_q``) on NHWC int8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool(x, *, size: int, stride: int, pad: int, pad_value=None):
    """Darknet maxpool on NCHW x. ``pad_value`` replaces the -inf pad
    identity (the int8 path pads with iinfo(int8).min).

    The same formulation serves training: ``F.max_pool2d`` keeps the
    first strict maximum of each window in row-major order, so its
    backward routes each window's gradient to the first maximal tap —
    darknet's rule (maxpool_layer.c:95-108) and the JAX package's
    ``maxpool(for_training=True)``. Where windows overlap (size 2, stride
    1) the CUDA backward adds with atomics, in no fixed order."""
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


def avgpool_global(x):
    """Global average pool of NCHW x -> (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


def lrn(x, *, size: int, alpha: float, beta: float, kappa: float):
    """Local response normalization across the channels of NCHW x, with
    darknet's running-sum quirk (normalization_layer.c:66-96, derived in
    the JAX module's docstring): its init loop adds channels [0, size//2),
    one short, while the removal step still subtracts channel size//2, so

        norms[k] = kappa + alpha * (sum_{j=max(0,k-(size-1)//2)}
                                        ^{min(c-1,k+size//2)} x[j]^2
                                    - x[size//2]^2)

    a clipped window sum minus the square of the fixed channel size//2.
    Returns x * norms^-beta."""
    c = x.shape[1]
    sq = x * x
    h1 = (size - 1) // 2   # taps behind
    h2 = size // 2         # taps ahead
    sq_p = F.pad(sq, (0, 0, 0, 0, h1, h2))
    sums = sq_p[:, 0:c]
    for t in range(1, size):
        sums = sums + sq_p[:, t:t + c]
    if h2 < c:
        sums = sums - sq[:, h2:h2 + 1]
    norms = kappa + alpha * sums
    return x * torch.pow(norms, -beta)


__all__ = ["maxpool", "maxpool_i8", "avgpool_global", "lrn"]
