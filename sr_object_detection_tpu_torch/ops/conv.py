"""Convolution / batchnorm / bias ops for inference, NCHW inside.

Counterpart of ``sr_object_detection_tpu/ops/conv.py`` (``conv2d``,
``batchnorm_inference``, ``bias_add``, the inference half of
``conv_block``, ``fold_batchnorm``). The JAX package runs NHWC/HWIO;
here the tensors handed between layers are NCHW with OIHW weights, the
layout ``F.conv2d`` takes natively. ``graph/compiler.py`` converts at
the network's boundary, so public layouts stay NHWC.

Parity-critical details kept from the reference:
  * forward order is conv -> batchnorm(normalize+scale) -> +bias -> act
    (convolutional_layer.c:455-473);
  * batchnorm divides by (sqrt(var) + 1e-6): epsilon OUTSIDE the sqrt
    (blas.c:122) — ``F.batch_norm`` puts it inside and is never used;
  * with a compute dtype (the bf16 serving path) the conv output is
    rounded to that dtype BEFORE the bias, as the JAX chain does
    (its conv has no preferred_element_type), then bias + activation run
    in float32 and the result is rounded once more.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-6  # blas.c:122 — added outside sqrt


def conv2d(x, w, *, stride: int, pad: int, compute_dtype=None):
    """NCHW conv with OIHW ``w``; returns float32.

    compute_dtype=None: float32 operands (a narrower input upcasts
    exactly). With a compute dtype both operands are cast, the conv runs
    in that dtype (float32 accumulation inside the library kernel) and
    its rounded output is widened back to float32."""
    if compute_dtype is not None:
        y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype),
                     stride=stride, padding=pad)
        return y.float()
    return F.conv2d(x.to(w.dtype), w, stride=stride, padding=pad).float()


def _channel(v):
    return v.reshape(1, -1, 1, 1)


def batchnorm_inference(x, scales, rolling_mean, rolling_var):
    """(x - mean) / (sqrt(var) + eps) * scale, per channel of NCHW x,
    folded to one multiply-add exactly as the JAX version computes it."""
    inv = scales / (torch.sqrt(rolling_var) + BN_EPS)
    return x * _channel(inv) + _channel(-rolling_mean * inv)


def bias_add(y, b):
    """y + b over the channel axis of NCHW y (b cast to y's dtype)."""
    return y + _channel(b.to(y.dtype))


def conv_block(x, params, spec, activation_fn, *, compute_dtype=None):
    """Inference darknet conv layer: conv [+BN] + bias + activation.

    ``params``: 'weights' (OIHW), 'biases' (C,) and, with
    batch_normalize, 'scales', 'rolling_mean', 'rolling_variance'.
    XNOR convs are rejected where the network is built
    (``graph.compiler.ConvLayer``)."""
    y = conv2d(x, params["weights"], stride=spec.stride, pad=spec.pad,
               compute_dtype=compute_dtype)
    if spec.batch_normalize:
        y = batchnorm_inference(y, params["scales"], params["rolling_mean"],
                                params["rolling_variance"])
    y = bias_add(y, params["biases"])
    y = activation_fn(y)
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    return y


def fold_batchnorm(params):
    """Fold BN into conv weights + bias ('denormalize',
    convolutional_layer.c:321-334). ``params['weights']`` is OIHW.
    Returns a new dict with only 'weights' and 'biases'."""
    inv = params["scales"] / (torch.sqrt(params["rolling_variance"])
                              + BN_EPS)
    w = params["weights"] * inv.reshape(-1, 1, 1, 1)
    b = params["biases"] - params["rolling_mean"] * inv
    return {"weights": w, "biases": b}


__all__ = ["conv2d", "conv_block", "batchnorm_inference", "bias_add",
           "fold_batchnorm", "BN_EPS"]
