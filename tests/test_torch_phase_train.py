"""The fused leading training pair (kernels/phase_train.py) against the
port's unfused bf16 chain and against the JAX package's Pallas pair (in
interpret mode, as tests/test_phase_train.py runs it).

On the CPU the kernel wrappers take their plain versions, so these tests
pin the pair's arithmetic; tests/test_torch_cuda.py holds the CUDA
kernels to the plain versions on the card.

Tie rule (ROADMAP queue 3, item 4): the pair routes the pool gradient by
the first tap attaining the raw conv extreme in the direction of the
channel's BN slope, the JAX kernel's rule. The unfused chain routes by
the first maximum of the post-BN+leaky activation. The two differ only
where bf16 rounding ties taps that the raw values keep apart (or the
reverse): well under 1% of the windows, but each moves a whole x (x) dz
term, a few per cent of the weight gradient on a random cotangent. The
gradient comparison therefore zeroes the cotangent on those windows
(torch_parity.same_route).

The gram form's weight gradient takes its Sum x (x) y term as G @ w,
which skips the bf16 rounding of y; the bf16 chain instead rounds the
conv's input cotangent and its weight gradient to bf16. Against a
float64 evaluation of the chain's own formulas the pair sits within
1e-4 of the largest magnitude, the bf16 chain within a few 1e-3 at this
size (and up to a third at 416 x 416 x 128 on the card, where those
roundings add up over 22 M positions). So the weight gradient is held
at 1e-3 to that evaluation, and the scale and bias gradients, float32
sums on both sides, at 1e-3 to the chain's (torch_parity.
check_pair_gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
from sr_object_detection_tpu.graph import spec as JS
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.ops import conv as C
from sr_object_detection_tpu_torch.ops import pooling as P
from torch_parity import (assert_bf16_close, check_pair_gradient,
                          train_case)


def _case(B, H, Cin, Cout, seed):
    rng = np.random.RandomState(seed)
    kw = dict(index=0, h=H, w=H, c=Cin, inputs=H * H * Cin, out_h=H,
              out_w=H, out_c=Cout, outputs=H * H * Cout, size=3, stride=1,
              pad=1, filters=Cout, activation="leaky", batch_normalize=True)
    params = {
        "weights": rng.randn(3, 3, Cin, Cout).astype(np.float32) * 0.3,
        "biases": rng.randn(Cout).astype(np.float32) * 0.1,
        "scales": 1.0 + 0.2 * rng.randn(Cout).astype(np.float32),
        "rolling_mean": 0.05 * rng.randn(Cout).astype(np.float32),
        "rolling_variance": 1.0 + 0.1 * rng.rand(Cout).astype(np.float32),
    }
    params["scales"][1] = -0.7             # a channel with a negative slope
    x = rng.rand(B, H, H, Cin).astype(np.float32)
    r = rng.randn(B, H // 2, H // 2, Cout).astype(np.float32)
    return JS.ConvSpec(**kw), S.ConvSpec(**kw), params, x, r


def _torch_params(params):
    out = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    out["weights"] = out["weights"].permute(3, 2, 0, 1).contiguous()
    for k in ("weights", "scales", "biases"):
        out[k].requires_grad_(True)
    return out


def _chain(x, p, spec):
    y, bn = C.conv_block_train(x.permute(0, 3, 1, 2), p, spec,
                               compute_dtype=torch.bfloat16)
    return P.maxpool(y, size=2, stride=2, pad=0).permute(0, 2, 3, 1), bn


def _grads(fn, x, params, r):
    p = _torch_params(params)
    y, bn = fn(torch.from_numpy(x), p)
    (y.float() * torch.from_numpy(r)).sum().backward()
    return y, bn, {k: p[k].grad for k in ("weights", "scales", "biases")}


def test_fused_pair_matches_unfused_chain():
    _, spec, params, x, r = _case(16, 16, 3, 16, seed=3)
    yf, bnf, _ = _grads(lambda v, p: TPT.phase_train_block(v, p, spec), x,
                        params, r)
    yc, bnc, _ = _grads(lambda v, p: _chain(v, p, spec), x, params, r)
    assert yf.dtype == torch.bfloat16 and yf.shape == (16, 8, 8, 16)
    assert_bf16_close(yf.float().detach().numpy(),
                      yc.float().detach().numpy())
    for k in bnf:
        np.testing.assert_allclose(bnf[k].numpy(), bnc[k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    res = check_pair_gradient(TPT, C, P, spec,
                              train_case(3, 16, 16, 3, 16, "cpu",
                                         flat=False))
    assert res["fused"] <= 1e-3 and res["chain"] < 4e-2, res
    assert 0 < res["masked"] < 1e-2, res


def test_fused_pair_matches_jax_pallas_pair():
    """(128, 16, 16, 3) -> 16: forward at 3e-2, gradients at 4e-2 of the
    largest magnitude (tests/test_phase_train.py:68-70,125-129)."""
    jspec, spec, params, x, r = _case(128, 16, 3, 16, seed=5)
    JPT._INTERPRET = True
    try:
        jp = {k: jnp.asarray(v) for k, v in params.items()}

        def loss(p):
            y, _ = JPT.phase_train_block(jnp.asarray(x), p, jspec)
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(r)), y

        (_, jy), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        jy = np.asarray(jy, np.float32)
    finally:
        JPT._INTERPRET = False
    y, _, g = _grads(lambda v, p: TPT.phase_train_block(v, p, spec), x,
                     params, r)
    np.testing.assert_allclose(y.float().detach().numpy(), jy, rtol=3e-2,
                               atol=3e-2)
    for k in g:
        a = g[k].numpy()
        b = np.asarray(jg[k])
        if k == "weights":
            a = np.transpose(a, (2, 3, 1, 0))
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=4e-2, atol=4e-2 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("size", [320 + 32 * i for i in range(10)])
def test_pair_engages_at_every_multiscale_size(size):
    """detector train resizes tiny-yolo-voc (random=1) to 320..608: the
    fused pair engages at each size, and the kernels take its shapes."""
    spec = TZ.tiny_yolo_voc().resize(size, size)
    params = params_to_torch(spec, init_params(spec, seed=0), "cpu")
    net = Network(spec, params, compute_dtype=torch.bfloat16,
                  phase_train=True)
    assert net.phase_pair
    l0 = spec.layers[0]
    assert (l0.h, l0.w, l0.h % 2, l0.w % 2) == (size, size, 0, 0)
    assert TPT.supported(l0)
    assert not Network(spec, params, compute_dtype=torch.bfloat16).phase_pair
    assert not Network(spec, params, phase_train=True).phase_pair


def test_pair_runs_through_network_train_forward():
    """Network.forward(train=True) with the pair: the same pooled output
    and rolling statistics as the unfused network, and no layer-0 output
    (the full-resolution activation is never formed)."""
    spec = TZ.tiny_yolo_voc(width=32, height=32)
    params = params_to_torch(spec, init_params(spec, seed=2), "cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(
        4, 32, 32, 3).astype(np.float32))
    fused = Network(spec, params, compute_dtype=torch.bfloat16,
                    phase_train=True)
    plain = Network(spec, params, compute_dtype=torch.bfloat16)
    _, af = fused(x, keep_all=True, train=True)
    _, ap = plain(x, keep_all=True, train=True)
    assert 0 not in af["outputs"] and 0 in ap["outputs"]
    assert_bf16_close(af["outputs"][1].float().numpy(),
                      ap["outputs"][1].float().numpy())
    for k in ("rolling_mean", "rolling_variance"):
        np.testing.assert_allclose(af["bn"][0][k].numpy(),
                                   ap["bn"][0][k].numpy(), rtol=1e-5)
