"""Recurrent layers: RNN / GRU / CRNN (darknet semantics).

Counterpart of ``sr_object_detection_tpu/ops/rnn.py``. The reference
unrolls time by folding ``time_steps`` into the batch dimension
**step-major** (rnn_layer.c:82-121, gru_layer.c:140-193,
crnn_layer.c:91-130): the input is (steps*b, ...) with step t's rows at
[t*b, (t+1)*b). The JAX module runs the recurrence with ``lax.scan``;
PyTorch runs eagerly, so here it is a Python loop over the steps.

Recurrences (every sublayer is a darknet connected or 3x3 conv layer
with its own activation, through ``ops.conv.connected`` /
``ops.conv.conv_block``):
  RNN:  h_t   = inp(x_t) + self(h_{t-1})
        out_t = out(h_t)
  GRU:  z = sigmoid(iz(x)+sz(h));  r = sigmoid(ir(x)+sr(h))
        hh = sigmoid(ih(x) + sh(r*h))        (LOGISTIC: USET undefined)
        out = z*h + (1-z)*hh;  h' = out      (weighted_sum_cpu:blas.c:49)
  CRNN: the RNN recurrence with 3x3 stride-1 pad-1 conv sublayers, NCHW.

A layer's parameters are the port's flat dict, one ``<sublayer>.<name>``
key a tensor (``io/convert.py``); :func:`sublayers` groups them.

Kept as the JAX module has them (ROADMAP queue 3): the cfg's
``shortcut`` is read and dropped, so h_t never adds h_{t-1}; the
returned BN updates are always {}, so training never moves the
sublayers' rolling statistics; the CRNN's sublayers run ``conv_block``
for inference (rolling statistics) in training too; the GRU's candidate
state uses a sigmoid, not tanh.
"""

from __future__ import annotations

import torch

from . import conv as C
from .activations import get_activation


def sublayers(params: dict) -> dict:
    """A layer's ``<sublayer>.<name>`` tensors -> one dict a sublayer."""
    out = {}
    for k, v in params.items():
        sub, _, name = k.partition(".")
        out.setdefault(sub, {})[name] = v
    return out


def _split_steps(x, steps: int):
    """(steps*b, ...) step-major -> (steps, b, ...)."""
    return x.reshape(steps, x.shape[0] // steps, *x.shape[1:])


def _connected(p, x, activation: str, batch_normalize: bool,
               train: bool = False):
    """Sublayer connected forward. In training BN uses batch statistics
    (forward_batchnorm_layer with state.train, batchnorm_layer.c:130);
    the rolling-statistic updates are discarded, as the JAX module's
    scan discards them."""
    act = get_activation(activation)
    if batch_normalize and train:
        y, _ = C.connected(x, p, act, batch_normalize=True, train=True)
        return y
    return C.connected(x, p, act, batch_normalize=batch_normalize)


def rnn_forward(x, params, spec, *, time_steps: int, train: bool = False,
                state=None):
    """x: (steps*b, inputs) step-major. Returns (out, bn_updates)."""
    xs = _split_steps(x, time_steps)
    params = sublayers(params)
    h = (torch.zeros((xs.shape[1], spec.hidden), dtype=x.dtype,
                     device=x.device) if state is None else state)
    outs = []
    for x_t in xs:
        i_out = _connected(params["input"], x_t, spec.activation,
                           spec.batch_normalize, train)
        s_out = _connected(params["self"], h, spec.activation,
                           spec.batch_normalize, train)
        h = i_out + s_out
        outs.append(_connected(params["output"], h, spec.activation,
                               spec.batch_normalize, train))
    return torch.cat(outs), {}


def rnn_forward_stateful(x_t, params, spec, state):
    """Single-step RNN for generation; returns (out, new_state)."""
    params = sublayers(params)
    i_out = _connected(params["input"], x_t, spec.activation,
                       spec.batch_normalize)
    s_out = _connected(params["self"], state, spec.activation,
                       spec.batch_normalize)
    h = i_out + s_out
    o = _connected(params["output"], h, spec.activation,
                   spec.batch_normalize)
    return o, h


def gru_forward(x, params, spec, *, time_steps: int, train: bool = False,
                state=None):
    """x: (steps*b, inputs) step-major. Returns (out, bn_updates)."""
    xs = _split_steps(x, time_steps)
    params = sublayers(params)
    h = (torch.zeros((xs.shape[1], spec.output), dtype=x.dtype,
                     device=x.device) if state is None else state)
    outs = []
    for x_t in xs:
        o, h = _gru_cell(x_t, params, h, spec.batch_normalize, train)
        outs.append(o)
    return torch.cat(outs), {}


def gru_cell(x_t, params, h, batch_normalize: bool, train: bool = False):
    """One GRU step -> (out, new state); the two are the same tensor."""
    return _gru_cell(x_t, sublayers(params), h, batch_normalize, train)


def _gru_cell(x_t, params, h, batch_normalize: bool, train: bool):
    lin = "linear"
    z = torch.sigmoid(
        _connected(params["input_z"], x_t, lin, batch_normalize, train)
        + _connected(params["state_z"], h, lin, batch_normalize, train))
    r = torch.sigmoid(
        _connected(params["input_r"], x_t, lin, batch_normalize, train)
        + _connected(params["state_r"], h, lin, batch_normalize, train))
    hh = torch.sigmoid(
        _connected(params["input_h"], x_t, lin, batch_normalize, train)
        + _connected(params["state_h"], r * h, lin, batch_normalize, train))
    out = z * h + (1.0 - z) * hh
    return out, out


class _SubSpec:
    """A CRNN sublayer's conv geometry (crnn_layer.c make_crnn_layer)."""
    stride = 1
    pad = 1

    def __init__(self, batch_normalize: bool):
        self.batch_normalize = batch_normalize


def crnn_forward(x, params, spec, *, time_steps: int, train: bool = False,
                 state=None):
    """x: NCHW (steps*b, c, h, w) step-major; the sublayers' weights
    OIHW. ``train`` changes nothing: the sublayers run ``conv_block``
    for inference, as the JAX module's do."""
    xs = _split_steps(x, time_steps)
    params = sublayers(params)
    h = (torch.zeros((xs.shape[1], spec.hidden_filters, spec.h, spec.w),
                     dtype=x.dtype, device=x.device)
         if state is None else state)
    sub = _SubSpec(spec.batch_normalize)
    act = get_activation(spec.activation)
    outs = []
    for x_t in xs:
        i_out = C.conv_block(x_t, params["input"], sub, act)
        s_out = C.conv_block(h, params["self"], sub, act)
        h = i_out + s_out
        outs.append(C.conv_block(h, params["output"], sub, act))
    return torch.cat(outs), {}


__all__ = ["sublayers", "rnn_forward", "rnn_forward_stateful", "gru_forward",
           "gru_cell", "crnn_forward"]
