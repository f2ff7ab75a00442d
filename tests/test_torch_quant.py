"""The port's int8 serving path (infer/quant.py, the int8 ops) and its
batch engines against the JAX package, on the CPU.

* ``conv2d_i8`` (both its CPU float64 route and its CUDA im2col +
  ``_int_mm`` route), the int8 maxpool and the requant are bit-exact to
  the JAX module's ``_conv_i8``, ``_maxpool_q`` and ``_requant``;
* ``quantize_for_inference`` gives the JAX module's qparams and scales
  bit for bit when both sides are fed the same ``calibrate_amax`` result
  (the two float32 calibration forwards differ in the last bits, and
  scales that differ move codes), and its int8 trunk equals the JAX int8
  chain;
* with ``quantize_head`` the whole int8 program agrees with the JAX
  one at float32 tolerance.

The engines are held to the JAX ones in tests/test_torch_engines.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.models import zoo as JZ
import sr_object_detection_tpu_torch.infer.quant as TQ
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
from sr_object_detection_tpu_torch.infer import engine as TE
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.ops import conv as TC
from sr_object_detection_tpu_torch.ops import pooling as TP
from int8_parity import NET, int8_net

@pytest.fixture(scope="module")
def net():
    return int8_net(NET)


@pytest.fixture
def same_calib(net, monkeypatch):
    """Both packages calibrate to JAX's amax for ``net``'s calibration
    batch."""
    amax = net[4]
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    return amax


# --------------------------------------------------------- int8 ops ---


@pytest.mark.parametrize("b,h,cin,cout,size,stride,pad", [
    (2, 9, 3, 16, 3, 1, 1),        # the first conv: K = 27, padded to 32
    (1, 7, 5, 7, 3, 2, 1),         # K = 45, N = 7: neither a multiple of 8
    (3, 6, 16, 125, 1, 1, 0),      # a 1x1 head, N = 125
    (1, 3, 8, 8, 3, 1, 1),         # M = 9 rows: padded past 16
])
def test_conv2d_i8_matches_jax(b, h, cin, cout, size, stride, pad):
    rng = np.random.default_rng(h * cin)
    x = rng.integers(-127, 128, (b, h, h + 1, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (size, size, cin, cout), dtype=np.int8)
    ref = np.asarray(JQ._conv_i8(jnp.asarray(x), jnp.asarray(w),
                                 stride=stride, pad=pad))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (TC.conv2d_i8(xt, wt, stride=stride, pad=pad),
                TC.conv2d_i8_int_mm(xt, wt, stride=stride, pad=pad)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("h,size,stride,pad", [
    (13, 2, 1, 0),                 # tiny-yolo layer 11: the overhang
    (26, 2, 2, 0), (9, 3, 1, 1), (11, 3, 2, 1)])
def test_maxpool_i8_matches_jax(h, size, stride, pad):
    x = np.random.default_rng(h).integers(-127, 128, (2, h, h, 5),
                                          dtype=np.int8)
    ref = np.asarray(JQ._maxpool_q(jnp.asarray(x), size=size,
                                   stride=stride, pad=pad))
    got = TP.maxpool_i8(torch.from_numpy(x), size=size, stride=stride,
                        pad=pad)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_requant_matches_jax():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(0, 3, 4096),
                        np.arange(-140, 140) + 0.5,      # .5: half to even
                        [1e9, -1e9, 0.0, -0.0]]).astype(np.float32)
    inv = np.float32(1 / 0.37)
    ref = np.asarray(jax.jit(JQ._requant)(jnp.asarray(v), inv))
    got = TPS.requant(torch.from_numpy(v), float(inv)).numpy()
    np.testing.assert_array_equal(got, ref)
    ref1 = np.asarray(JQ._requant(jnp.asarray(v), np.float32(1.0)))
    np.testing.assert_array_equal(TPS.requant(torch.from_numpy(v), 1.0),
                                  ref1)


# ---------------------------------------------------------- qparams ---


@pytest.mark.parametrize("quantize_head", [False, True])
def test_qparams_match_jax(net, same_calib, quantize_head):
    spec_j, spec_t, params, calib, _ = net
    qj = JQ.quantize_for_inference(spec_j, params, calib,
                                   quantize_head=quantize_head)
    qt = TQ.quantize_for_inference(spec_t, params, calib, device="cpu",
                                   quantize_head=quantize_head)
    assert qt.act_scales == qj.act_scales
    assert len(qt.qparams) == len(qj.qparams)
    for i, (pj, pt) in enumerate(zip(qj.qparams, qt.qparams)):
        assert pj.keys() == pt.keys(), i
        for k in pj:
            ref = np.asarray(pj[k])
            got = pt[k]
            assert str(got.dtype).split(".")[-1] == str(ref.dtype), (i, k)
            np.testing.assert_array_equal(got.float().numpy(),
                                          ref.astype(np.float32),
                                          err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_int8_trunk_matches_jax(net, same_calib, dtype):
    """The int8 activation that feeds the head (layer 12's output),
    against the JAX chain on the same qparams: bit-exact."""
    spec_j, spec_t, params, calib, amax = net
    qj = JQ.quantize_for_inference(spec_j, params, calib)
    qt = TQ.quantize_for_inference(spec_t, params, calib, device="cpu")
    in_scale = max(amax[0], 1.0) / JQ.I8MAX     # quant.py's input scale
    rng = np.random.RandomState(5)
    x = (rng.randint(0, 256, (3, NET, NET, 3)).astype(np.uint8)
         if dtype == np.uint8
         else rng.uniform(0, 1, (3, NET, NET, 3)).astype(np.float32))
    inv = (1.0 / (255.0 * in_scale)) if dtype == np.uint8 else 1.0 / in_scale

    @jax.jit
    def chain(v):
        cur = JQ._requant(v.astype(jnp.float32), np.float32(inv))
        for i, l in enumerate(qj.spec.layers[:13]):
            if isinstance(l, JS.ConvSpec):
                y = JQ._conv_i8(cur, qj.qparams[i]["weights"],
                                stride=l.stride, pad=l.pad)
                y = (y.astype(jnp.float32) * qj.qparams[i]["dequant"]
                     + qj.qparams[i]["biases"])
                y = jnp.where(y > 0, y, 0.1 * y)
                cur = JQ._requant(y, np.float32(1.0 / qj.act_scales[i]))
            else:
                cur = JQ._maxpool_q(cur, size=l.size, stride=l.stride,
                                    pad=l.pad)
        return cur

    ref = np.asarray(chain(jnp.asarray(x)))
    got = qt.forward(torch.from_numpy(x), stop=13)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert np.abs(ref).max() > 60           # the codes are non-trivial
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quantize_head_matches_jax(net, same_calib):
    """quantize_head=True: the head conv is int8 too, with a float32
    dequant epilogue, so only the region activation's exp differs between
    the frameworks: float32 tolerance."""
    spec_j, spec_t, params, calib, _ = net
    qj = JQ.quantize_for_inference(spec_j, params, calib,
                                   quantize_head=True)
    qt = TQ.quantize_for_inference(spec_t, params, calib, device="cpu",
                                   quantize_head=True)
    x = np.random.RandomState(2).uniform(0, 1, (2, NET, NET, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda v: qj.forward(qj.qparams, v))(
        jnp.asarray(x)))
    got = qt.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_calib_roundtrip_and_flops(tmp_path):
    x = np.random.RandomState(0).uniform(0, 1, (2, 8, 8, 3)).astype(
        np.float32)
    for name in ("c.npz", "c.npy"):
        TQ.save_calib(str(tmp_path / name), x)
        np.testing.assert_array_equal(TQ.load_calib(str(tmp_path / name)),
                                      JQ.load_calib(str(tmp_path / name)))
    np.save(tmp_path / "hwc.npy", x[0])
    assert TQ.load_calib(str(tmp_path / "hwc.npy")).shape == (1, 8, 8, 3)
    from sr_object_detection_tpu.infer.engine import analytic_flops
    for j, t in ((JZ.tiny_yolo_voc(), TZ.tiny_yolo_voc()),
                 (JZ.yolov2(), TZ.yolov2())):
        assert TE.analytic_flops(t) == analytic_flops(j)
