"""All 13 darknet activations as elementwise torch functions.

Counterpart of ``sr_object_detection_tpu/ops/activations.py``; reference
semantics src_yolo2/activations.h:22-85. Each keeps the JAX version's
expression so that float32 results agree bit for bit on the CPU.
"""

from __future__ import annotations

import sys

import torch


def logistic(x):
    return torch.sigmoid(x)


def loggy(x):
    return 2.0 * torch.sigmoid(x) - 1.0


def relu(x):
    return torch.clamp_min(x, 0)


def elu(x):
    return torch.where(x >= 0, x, torch.expm1(x))


def relie(x):
    return torch.where(x > 0, x, 0.01 * x)


def ramp(x):
    return x * (x > 0) + 0.1 * x


def leaky(x):
    return torch.where(x > 0, x, 0.1 * x)


def tanh_(x):
    return torch.tanh(x)


def plse(x):
    return torch.where(
        x < -4.0, 0.01 * (x + 4.0),
        torch.where(x > 4.0, 0.01 * (x - 4.0) + 1.0, 0.125 * x + 0.5))


def stair(x):
    n = torch.floor(x)
    half = torch.floor(x / 2.0)
    even = torch.remainder(n, 2) == 0
    return torch.where(even, half, (x - n) + half)


def hardtan(x):
    return torch.clamp(x, -1.0, 1.0)


def lhtan(x):
    return torch.where(
        x < 0, 0.001 * x,
        torch.where(x > 1, 0.001 * (x - 1.0) + 1.0, x))


def linear(x):
    return x


ACTIVATIONS = {
    "logistic": logistic,
    "loggy": loggy,
    "relu": relu,
    "elu": elu,
    "relie": relie,
    "ramp": ramp,
    "leaky": leaky,
    "tanh": tanh_,
    "plse": plse,
    "stair": stair,
    "hardtan": hardtan,
    "lhtan": lhtan,
    "linear": linear,
}


def get_activation(name: str):
    """Mirror get_activation (activations.c:43): unknown -> relu + warning."""
    fn = ACTIVATIONS.get(name)
    if fn is None:
        print(f"Couldn't find activation function {name}, going with ReLU",
              file=sys.stderr)
        return relu
    return fn


__all__ = ["ACTIVATIONS", "get_activation"] + list(ACTIVATIONS)
