"""YOLOv1's detection head in the port (train/detection_loss.py,
graph/compiler.py's DetectionLayer, the trainer's detection branch) on
the CPU:

* ``detection_delta`` against the JAX module's on random outputs and
  truths, with ties in the best-box IoU (two equal boxes in a cell) and
  cells whose boxes miss the truth (the rmse fallback), rescore, sqrt
  and forced each on and off: 1e-6 absolute;
* ``detection_loss``'s value and its gradient, -delta;
* the detection layer's forward with softmax 0 and 1 against the JAX
  ``build_forward``, and its training backward (straight through);
* ``train_yolov1.npz`` through ``torch_parity.check_detection_golden``
  (weights 1e-4, costs 1e-3 relative, as tests/test_train_parity.py);
* the port ``Trainer`` against the JAX ``Trainer`` on a detection net,
  3 steps at subdivisions 1 and 2: parameters and velocities within 1e-5
  of each tensor's largest value, losses 1e-5 relative.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.train.trainer as JT
from sr_object_detection_tpu.config import parse_cfg_text as j_parse
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.graph.compiler import build_forward
from sr_object_detection_tpu.train import detection_loss as JD
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.io.convert import (params_to_numpy,
                                                      params_to_torch)
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.train import detection_loss as D
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import (DETECTION_TRAIN_GOLDENS, check_detection_golden,
                          random_bn)

SIDE, NUM, CLASSES = 3, 2, 4


def _spec_pair(**kw):
    kw = dict(index=0, side=SIDE, n=NUM, classes=CLASSES, coords=4,
              coord_scale=5.0, noobject_scale=0.5, object_scale=1.0,
              class_scale=1.0, **kw)
    return S.DetectionSpec(**kw), JS.DetectionSpec(**kw)


def detection_case(seed, b=3):
    """(output, truth): random post-activation outputs and grid truths
    with a third of the cells holding an object; in cell 0 the two boxes
    are equal (tied IoUs), in cell 1 both miss the truth (the rmse
    fallback), and in cell 2 they are equal and miss it."""
    rng = np.random.default_rng(seed)
    s2 = SIDE * SIDE
    cls = rng.uniform(0, 1, (b, s2, CLASSES))
    cls /= cls.sum(-1, keepdims=True)
    obj = rng.uniform(0, 1, (b, s2, NUM))
    boxes = np.concatenate([rng.uniform(0, 1, (b, s2, NUM, 2)),
                            rng.uniform(0.2, 0.9, (b, s2, NUM, 2))], -1)
    truth = np.zeros((b, s2, 1 + CLASSES + 4))
    is_obj = rng.uniform(0, 1, (b, s2)) < 0.35
    is_obj[:, :3] = True
    truth[..., 0] = is_obj
    truth[np.arange(b)[:, None], np.arange(s2)[None],
          1 + rng.integers(0, CLASSES, (b, s2))] = 1
    truth[..., 1 + CLASSES:1 + CLASSES + 2] = rng.uniform(0, 1, (b, s2, 2))
    truth[..., 1 + CLASSES + 2:] = rng.uniform(0.05, 0.6, (b, s2, 2))
    boxes[:, 0, 1] = boxes[:, 0, 0]
    # far from the truth (x, y in cell units; the truth's x/side is < .34)
    boxes[:, 1, :, 0] = 3.5 + np.arange(NUM)
    boxes[:, 1, :, 2:] = 0.05
    boxes[:, 2, :, 0] = 4.0
    boxes[:, 2, 1] = boxes[:, 2, 0]
    truth = truth * is_obj[..., None]
    out = np.concatenate([cls.reshape(b, -1), obj.reshape(b, -1),
                          boxes.reshape(b, -1)], 1)
    return out.astype(np.float32), truth.astype(np.float32)


@pytest.mark.parametrize("rescore,sqrt,forced",
                         list(itertools.product([0, 1], repeat=3)))
def test_detection_delta_matches_jax(rescore, sqrt, forced):
    spec, jspec = _spec_pair(rescore=bool(rescore), sqrt=bool(sqrt),
                             forced=bool(forced))
    out, truth = detection_case(10 * rescore + 4 * sqrt + 2 * forced)
    want = np.asarray(JD.detection_delta(jnp.asarray(out),
                                         jnp.asarray(truth), 0, jspec))
    got = D.detection_delta(torch.from_numpy(out), torch.from_numpy(truth),
                            spec).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0.1


def test_detection_best_box_ties_take_the_first():
    """Two equal boxes in a cell with an object: the object delta falls on
    box 0 (``argmax``'s first index), with and without a positive IoU."""
    spec, _ = _spec_pair(rescore=True)
    out, truth = detection_case(3)
    d = D.detection_delta(torch.from_numpy(out), torch.from_numpy(truth),
                          spec).numpy()
    s2 = SIDE * SIDE
    obj = out[:, s2 * CLASSES:s2 * (CLASSES + NUM)].reshape(-1, s2, NUM)
    dobj = d[:, s2 * CLASSES:s2 * (CLASSES + NUM)].reshape(-1, s2, NUM)
    for cell in (0, 2):
        # box 1 keeps its noobject delta, box 0 got the object's
        np.testing.assert_allclose(dobj[:, cell, 1], -0.5 * obj[:, cell, 1],
                                   rtol=1e-6)
        assert not np.allclose(dobj[:, cell, 0], -0.5 * obj[:, cell, 0])


def test_detection_loss_value_and_gradient():
    spec, jspec = _spec_pair(rescore=True, sqrt=True)
    out, truth = detection_case(5)
    x = torch.from_numpy(out).requires_grad_(True)
    loss = D.detection_loss(x, torch.from_numpy(truth), spec)
    loss.backward()
    d = D.detection_delta(torch.from_numpy(out), torch.from_numpy(truth),
                          spec)
    np.testing.assert_allclose(loss.item(), float((d ** 2).sum()), rtol=1e-6)
    torch.testing.assert_close(x.grad, -d)
    jl, jg = jax.value_and_grad(JD.detection_loss)(
        jnp.asarray(out), jnp.asarray(truth), 0, jspec)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


V1_NET = """
[net]
batch={batch}
subdivisions={subdivisions}
height=16
width=16
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.01
policy=constant

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=8
size=3
stride=2
pad=1
activation=leaky

[connected]
output={outputs}
activation=linear

[detection]
classes={classes}
coords=4
rescore=1
side={side}
num={num}
softmax={softmax}
sqrt=1
jitter=.2
object_scale=1
noobject_scale=.5
class_scale=1
coord_scale=5
"""


def _v1_text(batch, subdivisions, softmax=1):
    return V1_NET.format(batch=batch, subdivisions=subdivisions,
                         outputs=SIDE * SIDE * (CLASSES + 5 * NUM),
                         classes=CLASSES, side=SIDE, num=NUM,
                         softmax=softmax)


def _specs(text):
    return (S.build_network_spec(parse_cfg_text(text)),
            JS.build_network_spec(j_parse(text)))


@pytest.mark.parametrize("softmax", [0, 1])
def test_detection_layer_matches_jax(softmax):
    """The v1 net's inference forward at 1e-5 of the largest value, and
    the training backward of sum(out * w) to the connected layer's
    output: straight through the class softmax, as JAX's."""
    spec, jspec = _specs(_v1_text(2, 1, softmax))
    params = random_bn(init_params(spec, seed=1), 2)
    x = np.random.default_rng(3).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    want, _ = build_forward(jspec)(params, jnp.asarray(x))
    net = Network(spec, params_to_torch(spec, params, "cpu"))
    with torch.no_grad():
        got, _ = net(torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    w = np.random.default_rng(4).normal(0, 1, want.shape).astype(np.float32)
    raw = np.random.default_rng(5).normal(0, 2, want.shape).astype(
        np.float32)
    layer = net.layers[-1]
    r = torch.from_numpy(raw).requires_grad_(True)
    (layer(r, train=True) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(r.grad.numpy(), w)
    if softmax:
        s2 = SIDE * SIDE
        cls = layer(torch.from_numpy(raw))[:, :s2 * CLASSES]
        np.testing.assert_allclose(
            cls.reshape(2, s2, CLASSES).sum(-1).numpy(), 1, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(DETECTION_TRAIN_GOLDENS))
def test_detection_golden(name):
    assert check_detection_golden(name, "cpu") < 1e-3


@pytest.mark.parametrize("subdivisions", [1, 2])
def test_detection_trainer_matches_jax(subdivisions):
    """3 steps of the port and JAX Trainers on the v1 net from the same
    params on the same batches and grid truths: parameters, rolling
    statistics and velocities within 1e-5 of each tensor's largest
    value, losses 1e-5 relative."""
    b = 4
    spec, jspec = _specs(_v1_text(b, subdivisions))
    params = random_bn(init_params(spec, seed=6), 7)
    rng = np.random.default_rng(8)
    jt = JT.Trainer(jspec, params=params)
    tt = Trainer(spec, params=params, device="cpu")
    for step in range(3):
        x = rng.uniform(0, 1, (b, 16, 16, 3)).astype(np.float32)
        _, truth = detection_case(20 + step, b)
        lj = float(jt.step(jnp.asarray(x), jnp.asarray(truth))["loss"])
        lt = float(tt.step(x, truth)["loss"])
        assert lt == pytest.approx(lj, rel=1e-5)
    for tree in ("params", "velocity"):
        mine = params_to_numpy(spec, getattr(tt.state, tree))
        want = getattr(jt.state, tree)
        for i, l in enumerate(spec.layers):
            assert mine[i].keys() == want[i].keys()
            for k, v in want[i].items():
                v = np.asarray(v)
                np.testing.assert_allclose(
                    mine[i][k], v, rtol=0, atol=1e-5 * np.abs(v).max(),
                    err_msg=f"{tree} layer {i} ({l.kind}) {k}")
    assert int(tt.state.seen) == int(jt.state.seen) == 3 * b
    assert dataclasses.asdict(spec.layers[-1]) == \
        dataclasses.asdict(jspec.layers[-1])
