"""The port's training ops against the JAX package's: train-mode
batchnorm (float32 and bf16 cores, forward and darknet's hand-written
backward), bias_add's float32 bias gradient, the bf16 leaky and the
first-tap maxpool backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.ops import activations as JA
from sr_object_detection_tpu.ops import conv as JC
from sr_object_detection_tpu.ops import pooling as JP
from sr_object_detection_tpu_torch.ops import activations as TA
from sr_object_detection_tpu_torch.ops import conv as TC
from sr_object_detection_tpu_torch.ops import pooling as TP
from torch_parity import assert_bf16_close


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1,
                                                                   2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 8) * 2 + 3).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    rm = rng.randn(8).astype(np.float32)
    rv = rng.uniform(0.5, 2, 8).astype(np.float32)
    r = rng.randn(4, 6, 5, 8).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jdt)

    def jloss(xv, s):
        y, nrm, nrv, _, _, _ = JC.batchnorm_train(xv, s, jnp.asarray(rm),
                                                  jnp.asarray(rv))
        return jnp.sum(y.astype(jnp.float32) * r), (y, nrm, nrv)

    (_, (jy, jrm, jrv)), (jdx, jds) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(xj, jnp.asarray(scales))
    xt = _nchw(x).to(tdt).requires_grad_(True)
    st = torch.from_numpy(scales).requires_grad_(True)
    ty, trm, trv, _, _ = TC.batchnorm_train(xt, st, torch.from_numpy(rm),
                                            torch.from_numpy(rv))
    (ty.float() * _nchw(r)).sum().backward()
    assert ty.dtype == tdt and xt.grad.dtype == tdt
    np.testing.assert_allclose(trm.numpy(), np.asarray(jrm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trv.numpy(), np.asarray(jrv), rtol=1e-5,
                               atol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jdx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_close(_nhwc(ty), np.asarray(jy, np.float32))
        assert_bf16_close(_nhwc(xt.grad), np.asarray(jdx, np.float32))
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds),
                                   rtol=1e-4, atol=1e-4)


def test_bias_add_gradient_is_summed_in_float32():
    """16384 bf16 cotangents of 1.7: a bf16 accumulator stalls at 2048
    (the JAX package's saturation case); the float32 sum is 27852.8."""
    y = torch.zeros((1, 1, 128, 128), dtype=torch.bfloat16,
                    requires_grad=True)
    b = torch.zeros(1, requires_grad=True)
    out = TC.bias_add(y, b)
    assert out.dtype == torch.bfloat16
    out.backward(torch.full_like(out, 1.7))
    jb = jax.grad(lambda bv: jnp.sum(
        JC.bias_add(jnp.zeros((1, 128, 128, 1), jnp.bfloat16), bv)
        .astype(jnp.float32) * jnp.float32(
            float(torch.tensor(1.7, dtype=torch.bfloat16)))))(
        jnp.zeros(1, jnp.float32))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb), rtol=1e-6)
    assert abs(float(b.grad[0]) - 16384 * 1.703125) < 1.0


def test_leaky_bf16_matches_jax_on_every_value():
    """Every normal bf16 value in [-8, 8] (and 0): forward and backward
    bit-equal to the JAX chain's bf16 leaky (slope bf16(0.1) =
    0.10009765625); torch's 0.1 * x on bf16 would round another
    constant. Subnormal products are left out: XLA on the CPU flushes
    them to zero."""
    bits = np.arange(0, 1 << 16, dtype=np.uint32) << 16
    v = bits.view(np.float32)
    tiny = np.finfo(np.float32).tiny / 0.10009765625
    v = v[np.isfinite(v) & (np.abs(v) <= 8) & ((np.abs(v) >= tiny)
                                               | (v == 0))]
    xb = torch.from_numpy(v).to(torch.bfloat16)
    g = torch.from_numpy(np.random.RandomState(0).randn(v.size).astype(
        np.float32)).to(torch.bfloat16)
    xt = xb.clone().requires_grad_(True)
    yt = TA.get_activation("leaky", torch.bfloat16)(xt)
    yt.backward(g)
    xj = jnp.asarray(v).astype(jnp.bfloat16)
    yj, vjp = jax.vjp(JA.leaky, xj)
    (gj,) = vjp(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(yj, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(gj, np.float32))
    # the float32 slope rounds differently for some of them
    assert not torch.equal(TA.leaky(xb), yt.detach())


@pytest.mark.parametrize("size,stride,hw", [(2, 2, 8), (2, 1, 7)])
def test_maxpool_backward_routes_to_first_tap(size, stride, hw):
    """bf16 plateaus make ties in most windows: the training pool's
    gradient goes to the first maximal tap in row-major order, as the
    JAX reduce_window gradient does (test_ops.py::
    test_reduce_window_grad_is_first_tap), for 2/2/0 and the overlapping
    2/1/0 geometry with its right/bottom overhang (tiny-yolo's layer
    11). The CPU adds overlapping windows in a fixed order, so the
    gradients are compared exactly."""
    rng = np.random.RandomState(size * hw)
    x = np.round(rng.rand(2, hw, hw, 3) * 4) / 4          # many ties
    x = x.astype(np.float32)
    oh = (hw + 0) // stride
    r = rng.randn(2, oh, oh, 3).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        def jloss(v):
            y = JP.maxpool(v, size=size, stride=stride, pad=0,
                           for_training=True)
            return jnp.sum(y.astype(jnp.float32) * r)
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(x).astype(jdt)),
                        np.float32)
        xt = _nchw(x).to(tdt).requires_grad_(True)
        y = TP.maxpool(xt, size=size, stride=stride, pad=0)
        assert y.shape == (2, 3, oh, oh)
        (y.float() * _nchw(r)).sum().backward()
        np.testing.assert_array_equal(_nhwc(xt.grad), jg)
