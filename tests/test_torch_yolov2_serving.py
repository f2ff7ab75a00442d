"""The port's yolov2 int8 serving program on the CPU, against the JAX
package's: ``quantize_for_inference`` (route and reorg on int8 codes)
and the int8 batch-1 ``LatencyEngine``.

As in tests/test_torch_quant.py, both packages are fed JAX's
``calibrate_amax`` result: then the qparams and every scale, the route's
included, are equal bit for bit, and with ``quantize_head`` the whole
int8 program agrees at float32 tolerance. Without it the bf16 head conv
differs by up to one bf16 step (tests/test_torch_engines.py's gates).
The batch engines' phase stems on yolov2 are held in
tests/test_torch_yolov2_stem.py, the bf16 ``LatencyEngine`` with its
fused stem in tests/test_torch_yolov2.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.infer.engine import LatencyEngine as JLatency
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.models import zoo as JZ
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu_torch.infer.engine import LatencyEngine
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import random_bn

NET = 64           # yolov2 at 64x64: a 2x2 grid, layer 16 at 4x4
NF = 85            # region fields: x, y, w, h, objectness, 80 classes


@pytest.fixture(scope="module")
def net():
    """(JAX spec, port spec, numpy params, calibration batch, JAX amax)."""
    spec_j = JZ.yolov2(width=NET, height=NET)
    spec_t = TZ.yolov2(width=NET, height=NET)
    params = random_bn(j_init_params(spec_j, seed=0), 1, head_gain=4.0)
    calib = np.random.RandomState(0).uniform(
        0, 1, (2, NET, NET, 3)).astype(np.float32)
    pf, fspec = JQ.fold_params_for_inference(spec_j, params,
                                             dtype=jnp.float32)
    return (spec_j, spec_t, params, calib,
            JQ.calibrate_amax(fspec, pf, calib))


@pytest.fixture
def same_calib(net, monkeypatch):
    amax = net[4]
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    return amax


def _close_region(got, ref, *, raw_atol, act_atol):
    """Flat region outputs: the raw box fields within ``raw_atol``, the
    activated ones (logistic objectness, softmax classes) within
    ``act_atol`` (tests/test_torch_engines.py)."""
    got = np.asarray(got, np.float32).reshape(-1, NF)
    ref = np.asarray(ref, np.float32).reshape(-1, NF)
    np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=0,
                               atol=raw_atol)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=0,
                               atol=act_atol)
    assert np.abs(ref[:, :4]).max() > 0.5 and ref[:, 4].std() > 0.05


# ------------------------------------------------------ int8 program ---


@pytest.mark.parametrize("quantize_head", [False, True])
def test_quantize_matches_jax(net, same_calib, quantize_head):
    """qparams and scales equal, the route's (the largest of its
    sources') included; with ``quantize_head`` the whole program at
    float32 tolerance (the int8 trunk through route and reorg, and its
    requantized route source, are then exact), without it at the bf16
    head's gates."""
    spec_j, spec_t, params, calib, _ = net
    qj = JQ.quantize_for_inference(spec_j, params, calib,
                                   quantize_head=quantize_head)
    qt = TQ.quantize_for_inference(spec_t, params, calib, device="cpu",
                                   quantize_head=quantize_head)
    s = qt.act_scales
    assert s == qj.act_scales
    assert s[25] == s[16] and s[27] == s[26]       # route -9, reorg
    assert s[28] == max(s[27], s[24]) and s[27] != s[24]
    for i, (pj, pt) in enumerate(zip(qj.qparams, qt.qparams)):
        assert pj.keys() == pt.keys(), i
        for k in pj:
            np.testing.assert_array_equal(
                pt[k].float().numpy(), np.asarray(pj[k]).astype(np.float32),
                err_msg=f"layer {i} {k}")
    x = np.random.RandomState(2).uniform(0, 1, (2, NET, NET, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda v: qj.forward(qj.qparams, v))(
        jnp.asarray(x)))
    got = qt.forward(torch.from_numpy(x)).numpy()
    if quantize_head:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        _close_region(got, ref, raw_atol=2 ** -7, act_atol=2 ** -9)
    # stop: the int8 route's output (layer 28) feeds the last 3x3 conv
    trunk = qt.forward(torch.from_numpy(x), stop=29)
    assert trunk.dtype == torch.int8 and trunk.shape == (2, 2, 2, 1280)


# ---------------------------------------------------- LatencyEngine ---


def test_latency_engine_int8_matches_jax(net, same_calib):
    spec_j, spec_t, params, calib, _ = net
    ej = JLatency(spec_j, params, int8_calib=calib)
    et = LatencyEngine(spec_t, params, device="cpu", int8_calib=calib)
    x = np.random.RandomState(4).uniform(0, 1, (1, NET, NET, 3)).astype(
        np.float32)
    ref, _ = jax.jit(ej._fwd)(ej.params, jnp.asarray(x))
    got, _ = et.forward(torch.from_numpy(x))
    _close_region(got.numpy(), np.asarray(ref), raw_atol=2 ** -7,
                  act_atol=2 ** -9)
    frame = np.random.RandomState(5).randint(0, 256, (NET, NET, 3), np.uint8)
    bj, pj = (np.asarray(t) for t in ej(frame))
    bt, pt = (t.numpy() for t in et(frame))
    assert bt.shape == bj.shape == (20, 4) and pt.shape == pj.shape
    np.testing.assert_allclose(pt.max(-1), pj.max(-1), rtol=0, atol=2 ** -9)
    np.testing.assert_allclose(bt[0], bj[0], rtol=2 ** -6, atol=1e-3)
