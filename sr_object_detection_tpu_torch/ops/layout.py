"""Layout / graph-wiring ops: reorg, route, shortcut, flatten.

Counterpart of ``sr_object_detection_tpu/ops/layout.py``. There every
tensor is NHWC. Here ``graph/compiler.Network`` passes NCHW between its
layers and the int8 program (``infer/quant.py``) passes NHWC, so reorg
is defined once on NCHW, the reference's own CHW memory order, and its
NHWC forms permute around that one definition. The flat (B, N) tensors
of connected/softmax/cost layers are darknet's CHW raster, which is an
NCHW tensor's own order (:func:`nchw_to_flat`, :func:`flat_to_nchw`).
``dropout`` is the identity at inference; in training
:func:`dropout_keep` draws which elements stay (probability 1-p) and
:func:`dropout_masked` scales them by 1/(1-p). ``SECRET_NUM`` is the
truth value that the masked cost skips.
"""

from __future__ import annotations

import torch

SECRET_NUM = -1234.0   # darknet's masked-truth sentinel (cost_layer.c)


def reorg_darknet_nchw(x, *, stride: int):
    """Exact darknet reorg for reverse=0 (the YOLOv2 passthrough) on NCHW
    ``x`` (b, c, h, w) -> (b, c*s^2, h/s, w/s).

    Darknet reinterprets the input's raw CHW memory (blas.c:8-29, called
    from reorg_layer.c:83; derived in the JAX module's docstring): view it
    as (c/s^2, h*s, w*s), gather

      out[k = off*oc + c2, j, i] = v[c2, j*s + off//s, i*s + off%s]

    into a (c, h, w) buffer, and read that buffer as (c*s^2, h/s, w/s).
    NCHW is that memory, so each view is a ``reshape`` of the logical
    shape (which copies a tensor whose strides are not C order)."""
    b, c, h, w = x.shape
    s = stride
    if s == 1:
        return x
    oc = c // (s * s)
    v = x.reshape(b, oc, h, s, w, s)                  # (b, c2, j, oy, i, ox)
    out = v.permute(0, 3, 5, 1, 2, 4).reshape(b, c, h, w)
    return out.reshape(b, c * s * s, h // s, w // s)


def reorg_reverse_darknet_nchw(x, *, stride: int):
    """Darknet reorg with reverse=1 (reorg_cpu with forward=1): NCHW
    (b, c, h, w) -> (b, c/s^2, h*s, w*s), the gather of
    :func:`reorg_darknet_nchw` run as a scatter. With darknet's buffer
    reinterpretations around them, the two directions do not undo each
    other."""
    b, c, h, w = x.shape
    s = stride
    if s == 1:
        return x
    oc = c // (s * s)
    v = x.reshape(b, s, s, oc, h, w)                  # (b, oy, ox, c2, j, i)
    return v.permute(0, 3, 4, 1, 5, 2).reshape(b, oc, h * s, w * s)


def reorg_darknet(x, *, stride: int):
    """NHWC form of :func:`reorg_darknet_nchw`: (b, h, w, c) ->
    (b, h/s, w/s, c*s^2), the JAX module's ``reorg_darknet``."""
    return reorg_darknet_nchw(x.permute(0, 3, 1, 2),
                              stride=stride).permute(0, 2, 3, 1)


def reorg_reverse_darknet(x, *, stride: int):
    """NHWC form of :func:`reorg_reverse_darknet_nchw`."""
    return reorg_reverse_darknet_nchw(x.permute(0, 3, 1, 2),
                                      stride=stride).permute(0, 2, 3, 1)


def route(tensors, dim: int = -1):
    """Channel concat of same-spatial outputs (route_layer.c:73-86):
    ``dim`` is the channel axis, -1 for NHWC, 1 for NCHW."""
    return torch.cat(list(tensors), dim=dim)


def shortcut_nchw(x, from_x, activation_fn):
    """Residual add with stride/sample resampling (blas.c:57-81) on NCHW
    tensors: out = x; out[...] += from_x[resampled]; activation(out).
    Mismatched spatial dims take an integer stride (downsample the
    source) or sample (add into strided positions of the output), and
    mismatched channels add only the first min(c1, c2)."""
    _, c2, h2, w2 = x.shape
    _, c1, h1, w1 = from_x.shape
    stride = max(1, w1 // w2)
    sample = max(1, w2 // w1)
    minw, minh, minc = min(w1, w2), min(h1, h2), min(c1, c2)
    if stride == 1 and sample == 1 and (h1, w1, c1) == (h2, w2, c2):
        y = x + from_x
    else:
        add = from_x[:, :minc, :minh * stride:stride, :minw * stride:stride]
        y = x.clone()
        if sample == 1:
            y[:, :minc, :minh, :minw] += add
        else:
            y[:, :minc, :minh * sample:sample, :minw * sample:sample] += add
    return activation_fn(y)


def dropout(x):
    """Darknet dropout (dropout_layer.c) at inference: the identity (the
    parser even aliases its output to the previous layer's buffer,
    parser.c:660-665). Training draws :func:`dropout_keep` and applies
    :func:`dropout_masked`."""
    return x


def dropout_keep(x, rate: float, generator):
    """The training dropout's keep mask of x's shape: each element kept
    with probability 1 - rate, drawn on x's device from a generator seeded
    by one draw from ``generator`` (a CPU ``torch.Generator``), so no mask
    crosses from the host. The card's stream is not the CPU's, and the
    JAX package draws from ``jax.random``, a stream the port does not
    reproduce; a caller that needs one mask on both passes it in."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    g = torch.Generator(device=x.device).manual_seed(seed)
    return torch.rand(x.shape, generator=g, device=x.device) >= rate


def dropout_masked(x, keep, rate: float):
    """The training dropout's arithmetic on a boolean ``keep`` mask (the
    JAX module's ``jnp.where(keep, x / (1 - rate), 0)``)."""
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def nchw_to_flat(x):
    """Flatten NCHW -> (B, C*H*W): darknet's CHW raster is NCHW's order."""
    return x.reshape(x.shape[0], -1)


def flat_to_nchw(x, h: int, w: int, c: int):
    """Inverse of :func:`nchw_to_flat`."""
    return x.reshape(x.shape[0], c, h, w)


def nhwc_to_flat(x):
    """Flatten NHWC -> (B, C*H*W) in darknet CHW raster order."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def flat_to_nhwc(x, h: int, w: int, c: int):
    """Inverse of :func:`nhwc_to_flat`."""
    return x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1)


__all__ = ["reorg_darknet_nchw", "reorg_reverse_darknet_nchw",
           "reorg_darknet", "reorg_reverse_darknet", "route",
           "shortcut_nchw", "dropout", "dropout_keep", "dropout_masked",
           "SECRET_NUM",
           "nchw_to_flat", "flat_to_nchw", "nhwc_to_flat", "flat_to_nhwc"]
