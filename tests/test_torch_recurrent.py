"""The recurrent kinds in the port (ops/rnn.py, graph/compiler.py's rnn,
gru and crnn layers, io/convert.py's sublayer dicts, the trainer and SGD
over them) on the CPU:

* the C-oracle goldens ``mini_rnn``, ``mini_gru`` (2e-5, one step from
  zero state, as tests/test_parity.py runs them) and ``mini_crnn`` (2e-5,
  test_parity.py's ``_run``), through ``torch_parity.check_recurrent_golden``;
* ``rnn_forward``, ``gru_forward`` and ``crnn_forward`` against the JAX
  module's on the same seeded inputs and parameters (BN statistics
  randomized), with and without BN, in the inference and the training
  forwards: 1e-5 of the largest |value|; a cfg with ``shortcut=1`` gives
  the port what it gives JAX (the shortcut is read and dropped);
* the port ``Trainer`` against the JAX ``Trainer``, 3 steps at
  subdivisions 1 and 2, on a two-RNN + GRU + connected + softmax + cost
  net and on a CRNN net: parameters and velocities within 1e-5 of each
  tensor's largest value, losses 1e-5 relative, rolling statistics
  unchanged, as in JAX;
* a flat-input net's Trainer step (char_rnn's (B, inputs) rows).

``.weights`` byte-equal to the JAX package's for a seeded char_rnn and a
seeded CRNN net: tests/test_torch_host.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.train.trainer as JT
from sr_object_detection_tpu.config import parse_cfg_text as j_parse
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.ops import rnn as JR
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.io.convert import (flat, params_to_numpy,
                                                      params_to_torch)
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.ops import rnn as R
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import (RECURRENT_GOLDENS, check_recurrent_golden,
                          random_bn_nested)


@pytest.mark.parametrize("name", sorted(RECURRENT_GOLDENS))
def test_recurrent_golden(name):
    check_recurrent_golden(name, "cpu")


FLAT = """
[net]
batch={batch}
time_steps={steps}
subdivisions={subdivisions}
inputs=6
momentum=0.9
decay=0.0005
learning_rate=0.1
policy=constant

[rnn]
batch_normalize={bn}
output=8
hidden=8
activation=leaky
shortcut={shortcut}

[rnn]
batch_normalize={bn}
output=10
hidden=10
activation=leaky

[gru]
batch_normalize={bn}
output=9

[connected]
output=6
activation=leaky

[softmax]

[cost]
type=sse
"""

CRNN = """
[net]
batch={batch}
time_steps={steps}
subdivisions={subdivisions}
height=8
width=8
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.1
policy=constant

[crnn]
batch_normalize={bn}
output_filters=6
hidden_filters=5
activation=leaky
shortcut={shortcut}

[connected]
output=5
activation=linear

[cost]
type=sse
"""


def _specs(text):
    return (S.build_network_spec(parse_cfg_text(text)),
            JS.build_network_spec(j_parse(text)))


def _close(got, want, tol=1e-5, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("bn", [0, 1])
@pytest.mark.parametrize("kind", ["rnn", "gru", "crnn"])
def test_forward_matches_jax(kind, bn, train):
    """One recurrent layer, 4 steps of 4 streams, port against JAX at 1e-5
    of the largest |value|. Four streams, not three: at 3 rows a batch
    the training BN's statistics amplify the two packages' sum-order
    differences past that gate for some seeds."""
    steps, b = 4, 4
    text = (CRNN if kind == "crnn" else FLAT).format(
        batch=b, steps=steps, subdivisions=1, bn=bn, shortcut=0)
    spec, jspec = _specs(text)
    i = {"rnn": 0, "gru": 2, "crnn": 0}[kind]
    params = random_bn_nested(init_params(spec, seed=5), 7)
    rng = np.random.default_rng(9)
    if kind == "crnn":
        x = rng.uniform(-1, 1, (steps * b, 8, 8, 3)).astype(np.float32)
        want, bn_j = JR.crnn_forward(jnp.asarray(x), params[i],
                                     jspec.layers[i], time_steps=steps,
                                     train=train)
        got, bn_t = R.crnn_forward(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            params_to_torch(spec, params, "cpu")[i], spec.layers[i],
            time_steps=steps, train=train)
        got = got.permute(0, 2, 3, 1)
    else:
        x = rng.uniform(-1, 1, (steps * b, spec.layers[i].inputs)).astype(
            np.float32)
        jf, tf = ((JR.rnn_forward, R.rnn_forward) if kind == "rnn"
                  else (JR.gru_forward, R.gru_forward))
        want, bn_j = jf(jnp.asarray(x), params[i], jspec.layers[i],
                        time_steps=steps, train=train)
        got, bn_t = tf(torch.from_numpy(x),
                       params_to_torch(spec, params, "cpu")[i],
                       spec.layers[i], time_steps=steps, train=train)
    assert bn_t == bn_j == {}
    assert got.shape == want.shape
    _close(got, want, msg=f"{kind} bn={bn} train={train}")


@pytest.mark.parametrize("cfg", ["flat", "crnn"])
def test_network_with_shortcut_matches_jax(cfg):
    """shortcut=1 is read and dropped by both packages: the whole
    network's inference forward and every layer's output at 1e-5."""
    from sr_object_detection_tpu.graph.compiler import build_forward
    steps, b = 3, 2
    text = (FLAT if cfg == "flat" else CRNN).format(
        batch=b, steps=steps, subdivisions=1, bn=1, shortcut=1)
    spec, jspec = _specs(text)
    params = random_bn_nested(init_params(spec, seed=2), 3)
    rng = np.random.default_rng(4)
    shape = (steps * b, 6) if cfg == "flat" else (steps * b, 8, 8, 3)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    _, aux_j = build_forward(jspec)(params, jnp.asarray(x), keep_all=True)
    net = Network(spec, params_to_torch(spec, params, "cpu"))
    with torch.no_grad():
        _, aux = net(torch.from_numpy(x), keep_all=True)
    for i, l in enumerate(spec.layers):
        _close(aux["outputs"][i], aux_j["outputs"][i],
               msg=f"layer {i} ({l.kind})")


def _velocity_close(mine, want, spec, tree):
    for i, l in enumerate(spec.layers):
        got, want_i = flat(mine[i]), flat(want[i])
        assert got.keys() == want_i.keys(), (tree, i)
        for k, v in want_i.items():
            _close(got[k], v, msg=f"{tree} layer {i} ({l.kind}) {k}")


@pytest.mark.parametrize("cfg,subdivisions", [("flat", 1), ("flat", 2),
                                              ("crnn", 1), ("crnn", 2)])
def test_trainer_matches_jax(cfg, subdivisions):
    """3 steps of the port Trainer and the JAX Trainer from the same
    params on the same batches: parameters and velocities at 1e-5 of
    each tensor's largest value, losses 1e-5 relative; the recurrent
    sublayers' rolling statistics are where they started (their BN
    updates are {} in both packages). 8 streams: the training BN's
    statistics over 3 or 4 rows a step amplify the two packages'
    sum-order differences past these gates on the flat net."""
    steps, streams = 4, 8
    batch = steps * streams
    # the cfg's batch counts streams; the parser folds the steps in
    text = (FLAT if cfg == "flat" else CRNN).format(
        batch=streams * subdivisions, steps=steps,
        subdivisions=subdivisions, bn=1, shortcut=0)
    spec, jspec = _specs(text)
    assert spec.net.batch == batch
    params = random_bn_nested(init_params(spec, seed=11), 12)
    rng = np.random.default_rng(13)
    jt = JT.Trainer(jspec, params=params)
    tt = Trainer(spec, params=params, device="cpu")
    n_out = spec.layers[-1].inputs
    for _ in range(3):
        shape = ((batch * subdivisions, 6) if cfg == "flat"
                 else (batch * subdivisions, 8, 8, 3))
        x = rng.uniform(0, 1, shape).astype(np.float32)
        t = np.eye(n_out, dtype=np.float32)[
            rng.integers(0, n_out, batch * subdivisions)]
        lj = float(jt.step(jnp.asarray(x), jnp.asarray(t))["loss"])
        lt = float(tt.step(x, t)["loss"])
        assert lt == pytest.approx(lj, rel=1e-5)
    for tree in ("params", "velocity"):
        _velocity_close(params_to_numpy(spec, getattr(tt.state, tree)),
                        getattr(jt.state, tree), spec, tree)
    mine = params_to_numpy(spec, tt.state.params)
    moved = False
    for i, l in enumerate(spec.layers):
        got, init = flat(mine[i]), flat(params[i])
        for k, v in got.items():
            sub, _, name = k.rpartition(".")
            if sub and name.startswith("rolling_"):
                np.testing.assert_array_equal(v, init[k])
            elif sub and name == "weights":
                moved |= bool(np.abs(v - init[k]).max() > 0)
    assert moved
    assert int(tt.state.seen) == int(jt.state.seen) == 3 * batch * \
        subdivisions


def test_flat_input_dims():
    """A flat-input net's Trainer takes (B, inputs) rows: the resize key
    is the net's own size, and the training forward's units are the
    layers."""
    spec = TZ.char_rnn(hidden=8, batch=2, time_steps=2)
    assert dataclasses.asdict(spec.net)["inputs"] == 256
    tr = Trainer(spec, device="cpu")
    x = np.eye(256, dtype=np.float32)[[1, 2, 3, 4]]
    m = tr.step(x, x)
    assert np.isfinite(float(m["loss"]))
    assert list(tr._steps) == [(spec.net.h, spec.net.w)]
