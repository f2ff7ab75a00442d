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


def conv2d_i8(x_q, w_q, *, stride: int, pad: int):
    """Exact int8 convolution: NHWC int8 ``x_q`` x HWIO int8 ``w_q`` ->
    NHWC int32, the JAX package's ``infer.quant._conv_i8``
    (``lax.conv_general_dilated(..., preferred_element_type=int32)``).

    On the CPU it is a float64 conv over the integer values, which is
    exact: |acc| <= 127^2 * kh*kw*Cin stays far below 2^53. ``F.conv2d``
    takes no int8 on CUDA, so there it is an im2col of the int8 input
    followed by ``torch._int_mm`` (int32 accumulation, exact). _int_mm
    wants more than 16 rows and K, N multiples of 8, and cuBLASLt
    refuses some row counts that are not a multiple of 8 (126 rows with
    N = 128 on an H100): the rows (to a multiple of 8, at least 24), K
    (27 for a 3-channel 3x3 conv) and N are zero-padded, which is
    exact."""
    if x_q.device.type == "cpu":
        y = F.conv2d(x_q.permute(0, 3, 1, 2).double(),
                     w_q.permute(3, 2, 0, 1).double(), stride=stride,
                     padding=pad)
        return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()
    return conv2d_i8_int_mm(x_q, w_q, stride=stride, pad=pad)


def conv2d_i8_int_mm(x_q, w_q, *, stride: int, pad: int):
    """The CUDA route of :func:`conv2d_i8` (im2col + ``torch._int_mm``);
    it runs on the CPU too, where the tests hold it to the float64
    route."""
    kh, kw, cin, cout = w_q.shape
    b, h, w, _ = x_q.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w + 2 * pad - kw) // stride + 1
    xp = F.pad(x_q, (0, 0, pad, pad, pad, pad)) if pad else x_q
    k = kh * kw * cin
    kp, np_ = -(-k // 8) * 8, -(-cout // 8) * 8
    taps = [xp[:, dy:dy + stride * (oh - 1) + 1:stride,
               dx:dx + stride * (ow - 1) + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    if kp > k:
        taps.append(x_q.new_zeros((b, oh, ow, kp - k)))
    m = b * oh * ow
    cols = torch.cat(taps, dim=-1).reshape(m, kp)
    mp = max(24, -(-m // 8) * 8)
    if mp > m:
        cols = F.pad(cols, (0, 0, 0, mp - m))
    wm = F.pad(w_q.reshape(k, cout), (0, np_ - cout, 0, kp - k))
    y = torch._int_mm(cols, wm)
    return y[:m, :cout].reshape(b, oh, ow, cout)


def _channel(v):
    return v.reshape(1, -1, 1, 1)


def _sqrt_rn(v):
    """Correctly rounded square root. torch's float32 ``sqrt`` on the CPU
    is off by an ulp for some inputs (numpy's and XLA's are exact); the
    float64 root rounded to float32 is the correctly rounded float32
    root, so the folded weights and int8 scales match the JAX package's
    bit for bit."""
    return torch.sqrt(v.double()).to(v.dtype)


def batchnorm_inference(x, scales, rolling_mean, rolling_var):
    """(x - mean) / (sqrt(var) + eps) * scale, per channel of NCHW x,
    folded to one multiply-add exactly as the JAX version computes it."""
    inv = scales / (_sqrt_rn(rolling_var) + BN_EPS)
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
    inv = params["scales"] / (_sqrt_rn(params["rolling_variance"])
                              + BN_EPS)
    w = params["weights"] * inv.reshape(-1, 1, 1, 1)
    b = params["biases"] - params["rolling_mean"] * inv
    return {"weights": w, "biases": b}


__all__ = ["conv2d", "conv2d_i8", "conv_block", "batchnorm_inference",
           "bias_add", "fold_batchnorm", "BN_EPS"]
