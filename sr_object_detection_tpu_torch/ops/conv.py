"""Convolution / batchnorm / bias ops, NCHW inside.

Counterpart of ``sr_object_detection_tpu/ops/conv.py`` (``conv2d``,
``batchnorm_inference``, ``batchnorm_train`` with both hand-written
backwards (per channel of NCHW, or per feature of a flat tensor),
``bias_add`` with its float32 bias gradient, ``conv_block`` for
inference (with the XNOR branch) and training (which, as the JAX
module's, trains an XNOR conv on its real weights and input),
``connected`` for both, ``binarize_weights`` / ``binarize_input``,
``fold_batchnorm``). The JAX package runs NHWC/HWIO;
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

from .activations import get_activation

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


def _axis1(v, x):
    """(C,) v broadcast over axis 1 of x: NCHW, or flat (B, N)."""
    return v.reshape(1, -1, *([1] * (x.ndim - 2)))


def batchnorm_inference(x, scales, rolling_mean, rolling_var):
    """(x - mean) / (sqrt(var) + eps) * scale, per channel of NCHW x (or
    per feature of flat (B, N) x), folded to one multiply-add exactly as
    the JAX version computes it."""
    inv = scales / (_sqrt_rn(rolling_var) + BN_EPS)
    return x * _axis1(inv, x) + _axis1(-rolling_mean * inv, x)


class _BiasAdd(torch.autograd.Function):
    """y + b with the bias gradient summed in float32 (the JAX package's
    ``bias_add`` custom_vjp): autograd of ``y + b.to(bfloat16)`` would
    return a bf16-rounded sum, and a bf16 accumulator saturates."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.b_dtype = b.dtype
        return y + _channel(b.to(y.dtype))

    @staticmethod
    def backward(ctx, g):
        db = g.sum(dim=(0, 2, 3), dtype=torch.float32)
        return g, db.to(ctx.b_dtype)


def bias_add(y, b):
    """y + b over the channel axis of NCHW y (b cast to y's dtype); the
    bias gradient is summed in float32."""
    return _BiasAdd.apply(y, b)


# batchnorm_layer.c:74-115: the hand-written backward adds .00001f
EPS_B = 1e-5


def _moments_n(x):
    return x.shape[0] * x.shape[2] * x.shape[3]


class _BNCore(torch.autograd.Function):
    """float32 train-mode batchnorm (the JAX package's ``_bn_core``): the
    1/(N-1) variance, eps outside the sqrt, and darknet's hand-written
    backward (backward_batchnorm_layer, batchnorm_layer.c:147-157), which
    is not the autodiff gradient of the forward. NCHW, per channel."""

    @staticmethod
    def forward(ctx, x, scales):
        n = _moments_n(x)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - _channel(mean)) ** 2).sum(dim=(0, 2, 3)) / max(n - 1, 1)
        x_hat = (x - _channel(mean)) / _channel(_sqrt_rn(var) + BN_EPS)
        ctx.save_for_backward(x, scales, x_hat, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return x_hat * _channel(scales), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        # the cotangents of mean/var are ignored: the reference propagates
        # through the output only, rolling updates are not differentiated
        x, scales, x_hat, mean, var = ctx.saved_tensors
        n = _moments_n(x)
        dscales = (g * x_hat).sum(dim=(0, 2, 3))
        d = g * _channel(scales)
        sum_d = d.sum(dim=(0, 2, 3))
        mean_delta = sum_d * (-1.0 / _sqrt_rn(var + EPS_B))
        xm = x - _channel(mean)
        variance_delta = (d * xm).sum(dim=(0, 2, 3)) * (-0.5) * torch.pow(
            var + EPS_B, -1.5)
        dx = (d / _channel(_sqrt_rn(var) + EPS_B)
              + _channel(variance_delta) * 2.0 * xm / n
              + _channel(mean_delta) / n)
        return dx, dscales


def shifted_moments(x, shift):
    """Batch mean and variance of NCHW x per channel, float32, from
    single-pass moments shifted by ``shift`` (the rolling mean, no
    gradient): the 1/(N-1) variance clamped at 0 against a negative
    cancellation (the JAX package's ``_bn_core_fast`` and fused-stem
    ``_fused_stats``)."""
    n = _moments_n(x)
    xs = x.float() - _channel(shift)
    sx = xs.sum(dim=(0, 2, 3))
    sxx = (xs * xs).sum(dim=(0, 2, 3))
    mean = shift + sx / n
    return mean, torch.clamp_min((sxx - sx * sx / n) / max(n - 1, 1), 0.0)


class _BNCoreFast(torch.autograd.Function):
    """bf16 train-mode batchnorm (the JAX package's ``_bn_core_fast``):
    the same formulas with single-pass moments shifted by the rolling
    mean (no gradient), the variance clamped at 0 against a negative
    cancellation, the output rounded to bf16, and a backward that
    recomputes x_hat from (x, mean, var) instead of saving it."""

    @staticmethod
    def forward(ctx, x, scales, shift):
        mean, var = shifted_moments(x, shift)
        inv = 1.0 / (_sqrt_rn(var) + BN_EPS)
        y = ((x.float() - _channel(mean)) * _channel(inv)
             * _channel(scales)).to(x.dtype)
        ctx.save_for_backward(x, scales, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, scales, mean, var = ctx.saved_tensors
        n = _moments_n(x)
        dy = g.float()
        xm = x.float() - _channel(mean)
        x_hat = xm / _channel(_sqrt_rn(var) + BN_EPS)
        dscales = (dy * x_hat).sum(dim=(0, 2, 3))
        d = dy * _channel(scales)
        sum_d = d.sum(dim=(0, 2, 3))
        mean_delta = sum_d * (-1.0 / _sqrt_rn(var + EPS_B))
        variance_delta = (d * xm).sum(dim=(0, 2, 3)) * (-0.5) * torch.pow(
            var + EPS_B, -1.5)
        dx = (d / _channel(_sqrt_rn(var) + EPS_B)
              + _channel(variance_delta) * 2.0 * xm / n
              + _channel(mean_delta) / n).to(x.dtype)
        return dx, dscales, None


def batchnorm_train(x, scales, rolling_mean, rolling_var):
    """Train-mode batchnorm over NCHW x, or over the features of flat
    (B, N) x (a connected layer's, viewed as (B, N, 1, 1)). Returns
    (normalized * scale, new_rolling_mean, new_rolling_var, batch_mean,
    batch_var): the 1/(N-1) variance (blas.c:101), eps outside the sqrt
    (blas.c:122), the 0.9/0.1 rolling update (batchnorm_layer.c:133-136).
    A bf16 x takes the shifted single-pass core, float32 the two-pass
    one; both backwards are darknet's hand-written gradient."""
    if x.ndim == 2:
        y, rm, rv, mean, var = batchnorm_train(x[:, :, None, None], scales,
                                               rolling_mean, rolling_var)
        return y.reshape(x.shape), rm, rv, mean, var
    if x.dtype == torch.bfloat16:
        y, mean, var = _BNCoreFast.apply(x, scales, rolling_mean.detach())
    else:
        y, mean, var = _BNCore.apply(x, scales)
    mean, var = mean.detach(), var.detach()
    return (y, 0.9 * rolling_mean.detach() + 0.1 * mean,
            0.9 * rolling_var.detach() + 0.1 * var, mean, var)


def conv_block_train(x, params, spec, *, compute_dtype=None):
    """Training darknet conv layer: conv [+BN] + bias + activation on
    NCHW x. Returns (y, bn_updates or None).

    Rounds where the JAX source rounds (``ops/conv.conv_block(train=
    True)``): with a compute dtype the conv output is that dtype, BN
    runs on it and returns it, the bias is added in it and the
    activation runs on it (leaky with the bf16 slope); a conv without BN
    adds its bias in float32 and is rounded after the activation. An
    XNOR conv trains on its real weights and input, unbinarized, as the
    JAX module's ``conv_block(train=True)`` does."""
    w = params["weights"]
    if compute_dtype is not None:
        y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype),
                     stride=spec.stride, padding=spec.pad)
    else:
        y = F.conv2d(x.to(w.dtype), w, stride=spec.stride,
                     padding=spec.pad)
    bn = None
    if spec.batch_normalize:
        y, new_rm, new_rv, _, _ = batchnorm_train(
            y, params["scales"], params["rolling_mean"],
            params["rolling_variance"])
        bn = {"rolling_mean": new_rm, "rolling_variance": new_rv}
    else:
        y = y.float()
    y = bias_add(y, params["biases"])
    y = get_activation(spec.activation, y.dtype)(y)
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    return y, bn


def binarize_weights(w):
    """XNOR-net weight binarization (convolutional_layer.c:37-49) of OIHW
    ``w``: per filter, sign(w) * mean(|w|) (zero maps to -mean)."""
    mean = w.abs().mean(dim=(1, 2, 3), keepdim=True)
    return torch.where(w > 0, mean, -mean)


def binarize_input(x):
    """binarize_cpu (convolutional_layer.c:52-58): the sign in {+1, -1},
    zero mapping to -1, in x's dtype."""
    return torch.where(x > 0, 1.0, -1.0).to(x.dtype)


def conv_block(x, params, spec, activation_fn, *, compute_dtype=None):
    """Inference darknet conv layer: conv [+BN] + bias + activation.

    ``params``: 'weights' (OIHW), 'biases' (C,) and, with
    batch_normalize, 'scales', 'rolling_mean', 'rolling_variance'. An
    XNOR conv binarizes its weights and its input first
    (forward_convolutional_layer:443-448, the JAX module's XNOR branch);
    ``binary`` alone changes nothing at inference, as there."""
    w = params["weights"]
    if getattr(spec, "xnor", False):
        w = binarize_weights(w)
        x = binarize_input(x)
    y = conv2d(x, w, stride=spec.stride, pad=spec.pad,
               compute_dtype=compute_dtype)
    if spec.batch_normalize:
        y = batchnorm_inference(y, params["scales"], params["rolling_mean"],
                                params["rolling_variance"])
    y = bias_add(y, params["biases"])
    y = activation_fn(y)
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    return y


def connected(x, params, activation_fn, *, batch_normalize: bool = False,
              train: bool = False):
    """Fully-connected layer (connected_layer.c forward) on flat x
    (B, inputs): y = x @ W^T, W in darknet's (outputs, inputs) layout,
    then [BN], + bias, activation. The product runs in float32, as the
    JAX module's ``preferred_element_type=float32``: narrower operands
    widen exactly, and the output is float32 whatever x's dtype.

    ``train=True`` runs the batch-statistics BN over the batch and
    returns (y, bn_updates or None)."""
    y = F.linear(x.float(), params["weights"].float())
    bn = None
    if batch_normalize and train:
        y, new_rm, new_rv, _, _ = batchnorm_train(
            y, params["scales"], params["rolling_mean"],
            params["rolling_variance"])
        bn = {"rolling_mean": new_rm, "rolling_variance": new_rv}
    elif batch_normalize:
        y = batchnorm_inference(y, params["scales"], params["rolling_mean"],
                                params["rolling_variance"])
    y = activation_fn(y + params["biases"])
    return (y, bn) if train else y


def fold_batchnorm(params):
    """Fold BN into conv weights + bias ('denormalize',
    convolutional_layer.c:321-334). ``params['weights']`` is OIHW.
    Returns a new dict with only 'weights' and 'biases'."""
    inv = params["scales"] / (_sqrt_rn(params["rolling_variance"])
                              + BN_EPS)
    w = params["weights"] * inv.reshape(-1, 1, 1, 1)
    b = params["biases"] - params["rolling_mean"] * inv
    return {"weights": w, "biases": b}


__all__ = ["conv2d", "conv2d_i8", "conv_block", "conv_block_train",
           "connected", "binarize_weights", "binarize_input",
           "batchnorm_inference", "batchnorm_train", "shifted_moments",
           "bias_add",
           "fold_batchnorm", "BN_EPS", "EPS_B"]
