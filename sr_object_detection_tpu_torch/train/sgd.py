"""Darknet-exact SGD (momentum + decay) and learning-rate policies.

Counterpart of ``sr_object_detection_tpu/train/sgd.py``. Update rule
(update_convolutional_layer, src_yolo2/convolutional_layer.c:514-528;
connected/local identical), with g = +dL/dw summed over the batch:

    v   <- momentum * v_prev - g - decay*batch*w    ('weights' leaves)
    v   <- momentum * v_prev - g                    (biases/scales)
    w   <- w + lr/batch * v

LR policies mirror get_current_rate (src_yolo2/network.c:48-79).
Parameters are per-layer dicts of tensors (a recurrent layer's keys are
``<sublayer>.<name>``, and a sublayer's ``weights`` decay as a layer's
do); the update returns new tensors and leaves its inputs as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.spec import NetSpec

_ROLLING = ("rolling_mean", "rolling_variance")


def name(key: str) -> str:
    """A parameter key's name, a recurrent sublayer's prefix dropped."""
    return key.rpartition(".")[2]


def init_velocity(params):
    return [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]


def sgd_update(params, grads, velocity, *, lr, batch_size: int,
               momentum: float, decay: float):
    """One darknet SGD step. ``grads`` = dL/dw SUMMED over the batch (a
    missing entry counts as zero). BN rolling stats are not touched here:
    the trainer overwrites them from the forward pass's aux. ``lr`` is a
    float32 value (see :func:`learning_rate`)."""
    step = float(np.float32(lr) / np.float32(batch_size))
    new_params, new_vel = [], []
    for p, g, v in zip(params, grads, velocity):
        np_, nv = {}, {}
        for k, w in p.items():
            if name(k) in _ROLLING:
                np_[k], nv[k] = w, v[k]
                continue
            gk = g.get(k)
            new_v = momentum * v[k] if gk is None else momentum * v[k] - gk
            if name(k) == "weights":
                new_v = new_v - (decay * batch_size) * w
            np_[k] = w + step * new_v
            nv[k] = new_v
        new_params.append(np_)
        new_vel.append(nv)
    return new_params, new_vel


def learning_rate(net: NetSpec, batch_num: int) -> float:
    """get_current_rate (network.c:48-79) in float32, as the JAX
    package's jittable version computes it (its 'random' policy falls
    back to constant; the host-side draw is :func:`learning_rate_py`)."""
    f32 = np.float32
    bn = f32(batch_num)
    base = f32(net.learning_rate)
    if net.policy in ("constant", "random"):
        return float(base)
    if net.policy == "step":
        return float(base * np.power(f32(net.scale),
                                     np.floor(bn / f32(net.step))))
    if net.policy == "steps":
        rate = base
        for s, sc in zip(net.steps, net.scales):
            if bn >= s:
                rate = f32(rate * f32(sc))
        return float(rate)
    if net.policy == "exp":
        return float(base * np.power(f32(net.gamma), bn))
    if net.policy == "poly":
        if bn < net.burn_in:
            return float(base * np.power(bn / f32(max(net.burn_in, 1)),
                                         f32(net.power)))
        return float(base * np.power(
            f32(1.0) - bn / f32(max(net.max_batches, 1)), f32(net.power)))
    if net.policy == "sigmoid":
        return float(base / (f32(1.0) + np.exp(
            f32(net.gamma) * (bn - f32(net.step)))))
    return float(base)


def learning_rate_py(net: NetSpec, batch_num: int) -> float:
    """Host-side exact version incl. the 'steps' short-circuit quirk:
    the reference stops at the first step > batch_num, so an unsorted
    steps list behaves order-dependently — preserved here."""
    if net.policy == "constant":
        return net.learning_rate
    if net.policy == "step":
        return net.learning_rate * (net.scale ** (batch_num // net.step))
    if net.policy == "steps":
        rate = net.learning_rate
        for s, sc in zip(net.steps, net.scales):
            if s > batch_num:
                return rate
            rate *= sc
        return rate
    if net.policy == "exp":
        return net.learning_rate * (net.gamma ** batch_num)
    if net.policy == "poly":
        if batch_num < net.burn_in:
            return net.learning_rate * (
                (batch_num / max(net.burn_in, 1)) ** net.power)
        return net.learning_rate * (
            (1 - batch_num / max(net.max_batches, 1)) ** net.power)
    if net.policy == "random":
        return net.learning_rate * (np.random.uniform() ** net.power)
    if net.policy == "sigmoid":
        return net.learning_rate * (
            1.0 / (1.0 + np.exp(net.gamma * (batch_num - net.step))))
    return net.learning_rate


def adam_update(w, g, m, v, *, lr, batch_size: int, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-6, decay: float = 0.0,
                t: int = 1):
    """Darknet Adam for conv weights (update_convolutional_layer_gpu,
    convolutional_kernels.cu:260-272 + adam_kernel, blas_kernels.cu:143):

        wu = -(g + decay*batch*w)                (weight_updates)
        m  = B1*m + (1-B1)*(g + decay*batch*w)
        v  = B2*v + (1-B2)*wu^2
        w  = w - lr/batch * sqrt(1-B2^t)/(1-B1^t) * m/(sqrt(v)+eps)

    ``g`` is +dL/dw summed over the batch; ``t`` is the 1-based update
    counter. No shipped cfg enables adam, so the Trainer stays on SGD."""
    gd = g + decay * batch_size * w
    new_m = b1 * m + (1.0 - b1) * gd
    new_v = b2 * v + (1.0 - b2) * gd * gd
    rate = (lr / batch_size) * np.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
    new_w = w - rate * new_m / (torch.sqrt(new_v) + eps)
    return new_w, new_m, new_v


__all__ = ["init_velocity", "sgd_update", "learning_rate",
           "learning_rate_py", "adam_update"]
