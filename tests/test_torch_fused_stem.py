"""The fused training stem (kernels/fused_stem.py) against the JAX
package's ``fused_bn_leaky_pool`` (its Pallas kernels in interpret mode,
as tests/test_fused_stem.py runs them) and against the port's unfused
bf16 chain (conv_block_train + maxpool).

On the CPU the kernel wrappers take their plain versions, so these tests
pin the arithmetic of F2, B1 and B2; tests/test_torch_cuda.py holds the
CUDA kernels to the plain versions on the card. The JAX op runs on HWCN
with the batch in the lanes (B = 128); the port's on the NCHW conv
output. As in tests/test_fused_stem.py: at the same statistics the pooled
output is bit-exact; the statistics differ only in the float32 summation
order (1e-5); the gradients are compared on a coarse value grid, where
that round-off cannot flip a pool tap or a leaky sign, at 3e-5 (scale
and bias) and 1e-2 (the bf16 dy), with the same routing pattern.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.fused_stem as JFS
import sr_object_detection_tpu_torch.kernels.fused_stem as TFS
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.ops import conv as C
from sr_object_detection_tpu_torch.ops import pooling as P
from sr_object_detection_tpu_torch.ops.conv import BN_EPS, _sqrt_rn
from torch_parity import check_fused_op, stem_case


@pytest.fixture(autouse=True)
def _interpret():
    JFS._INTERPRET = True
    yield
    JFS._INTERPRET = False


def _mk(C=16, H=16, W=32, B=128, seed=0, coarse=False):
    """tests/test_fused_stem.py's _mk: y (B,H,W,C) bf16 with exact ties in
    some windows, scales, biases, shift (numpy float32)."""
    rng = np.random.RandomState(seed)
    y = rng.normal(0, 1.5, (B, H, W, C)).astype(np.float32)
    if coarse:
        y = np.round(y * 8) / 8
    y[:, 0:2, 0:2, :] = 0.75
    y[:, H - 2, W - 2, :] = y[:, H - 2, W - 1, :]
    y = np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    scales = rng.uniform(0.5, 1.5, C).astype(np.float32)
    biases = rng.uniform(-0.5, 0.5, C).astype(np.float32)
    shift = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    if coarse:
        scales = np.round(scales * 8) / 8
        biases = np.round(biases * 8) / 8
        shift = np.zeros_like(shift)
    return y, scales, biases, shift


def _jax_op(y, scales, biases, shift):
    """JAX fused op on the NHWC numpy y: (pooled NHWC, mean, var)."""
    p, mean, var = JFS.fused_bn_leaky_pool(
        jnp.transpose(jnp.asarray(y, jnp.bfloat16), (1, 2, 3, 0)),
        *map(jnp.asarray, (scales, biases, shift)))
    return (np.asarray(jnp.transpose(p, (3, 0, 1, 2)), np.float32),
            np.asarray(mean), np.asarray(var))


def _nchw(y, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(
        np.transpose(y, (0, 3, 1, 2)))).to(torch.bfloat16)
    return t.requires_grad_(grad)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("C,H,W", [(16, 16, 32), (32, 8, 16), (8, 4, 6),
                                   (256, 4, 26)])
def test_forward_bit_exact_at_fixed_statistics(C, H, W):
    """F2 with the JAX op's own mean and var equals its pooled output bit
    for bit (tests/test_fused_stem.py:84-94)."""
    y, scales, biases, shift = _mk(C, H, W)
    p_j, mean, var = _jax_op(y, scales, biases, shift)
    mean, var = torch.tensor(mean), torch.tensor(var)
    inv = 1.0 / (_sqrt_rn(var) + BN_EPS)
    p_t = TFS.f2_plain(_nchw(y), mean, inv, torch.from_numpy(scales),
                       torch.from_numpy(biases))
    np.testing.assert_array_equal(_nhwc(p_t), p_j)


def test_statistics_match_jax():
    """The batch mean and variance at 1e-5 of a float64 evaluation
    (tests/test_fused_stem.py:97-105). The JAX op's own float32 sums, in
    XLA's order on the CPU, sit 3.2e-5 off it at this size (65,536 values
    a channel): port and JAX are held to each other at 1e-4."""
    y, scales, biases, shift = _mk()
    _, mean_j, var_j = _jax_op(y, scales, biases, shift)
    _, mean_t, var_t = TFS.fused_bn_leaky_pool(
        _nchw(y), *map(torch.from_numpy, (scales, biases, shift)))
    y64 = y.astype(np.float64)
    mean64 = y64.mean(axis=(0, 1, 2))
    var64 = ((y64 - mean64) ** 2).sum(axis=(0, 1, 2)) / (y.size // 16 - 1)
    for got, want, j in ((mean_t, mean64, mean_j), (var_t, var64, var_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), j, rtol=1e-4, atol=1e-4)


def _grads_jax(y, scales, biases, shift, weight=1.7):
    def loss(y_, s_, b_):
        p, _, _ = JFS.fused_bn_leaky_pool(y_, s_, b_, jnp.asarray(shift))
        return jnp.sum(p.astype(jnp.float32) * weight)

    gy, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.transpose(jnp.asarray(y, jnp.bfloat16), (1, 2, 3, 0)),
        jnp.asarray(scales), jnp.asarray(biases))
    return (np.asarray(jnp.transpose(gy, (3, 0, 1, 2)), np.float32),
            np.asarray(gs), np.asarray(gb))


def _grads_torch(y, scales, biases, shift, weight=1.7):
    yt = _nchw(y, grad=True)
    st, bt = (torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (scales, biases))
    p, _, _ = TFS.fused_bn_leaky_pool(yt, st, bt, torch.from_numpy(shift))
    (p.float() * weight).sum().backward()
    return p, _nhwc(yt.grad), st.grad.numpy(), bt.grad.numpy()


def test_end_to_end_matches_jax_on_coarse_grid():
    """Forward and every gradient against the JAX op, B1's sums through
    the scale and bias gradients and B2's dy directly
    (tests/test_fused_stem.py:108-144)."""
    y, scales, biases, shift = _mk(16, 16, 32, coarse=True)
    p_j, _, _ = _jax_op(y, scales, biases, shift)
    gy_j, gs_j, gb_j = _grads_jax(y, scales, biases, shift)
    p_t, gy_t, gs_t, gb_t = _grads_torch(y, scales, biases, shift)
    np.testing.assert_array_equal(_nhwc(p_t), p_j)
    np.testing.assert_allclose(gs_t, gs_j, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(gb_t, gb_j, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(gy_t, gy_j, rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(gy_t != 0, gy_j != 0)


def test_tie_routing_is_first_tap():
    """All four taps equal: the whole cotangent lands on the first tap
    (row-major) on both sides (tests/test_fused_stem.py:147-174); through
    B2 at fixed constants with c2 = c3 = 0 only the first taps are
    nonzero."""
    c, h, w, b = 8, 4, 4, 128
    y = np.full((b, h, w, c), 0.5, np.float32)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    gy_j, _, _ = _grads_jax(y, ones, zeros, zeros, weight=1.0)
    _, gy_t, _, _ = _grads_torch(y, ones, zeros, zeros, weight=1.0)
    np.testing.assert_array_equal(gy_t, gy_j)
    k = [torch.from_numpy(a) for a in (zeros + 0.5, ones, ones, zeros)]
    dy = _nhwc(TFS.b2_plain(_nchw(y), torch.ones((b, c, h // 2, w // 2),
                                                 dtype=torch.bfloat16),
                            *k, torch.ones(c), torch.zeros(c),
                            torch.zeros(c)))
    assert dy[:, 0::2, 0::2, :].all() and not dy[:, 1::2].any() \
        and not dy[:, :, 1::2].any()


@pytest.mark.parametrize("channels_last", [True, False])
def test_fused_op_matches_unfused_chain(channels_last):
    """The fused op against the port's unfused chain (BN core, bias, bf16
    leaky, maxpool) on the same conv output y, in either memory format
    (torch_parity.check_fused_op, which the card runs at full size)."""
    rel, dy = check_fused_op(TFS, C, P, stem_case(3, 8, 16, 32, "cpu",
                                                  channels_last))
    assert rel <= 1e-3 and dy <= 2 ** -6


def _conv_case(b=8, h=12, cin=8, cout=16, seed=4):
    rng = np.random.default_rng(seed)
    spec = S.ConvSpec(index=2, h=h, w=h, c=cin, inputs=h * h * cin,
                      out_h=h, out_w=h, out_c=cout, outputs=h * h * cout,
                      size=3, stride=1, pad=1, filters=cout,
                      activation="leaky", batch_normalize=True)
    x = rng.uniform(0, 1, (b, cin, h, h)).astype(np.float32)
    p = {"weights": rng.normal(0, 0.3, (cout, cin, 3, 3)),
         "scales": rng.uniform(0.6, 1.4, cout),
         "biases": rng.normal(0, 0.2, cout),
         "rolling_mean": rng.normal(0, 0.1, cout),
         "rolling_variance": rng.uniform(0.6, 1.6, cout)}
    return spec, x, {k: v.astype(np.float32) for k, v in p.items()}


def _block_grads(fn, x, params, r):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for k in ("weights", "scales", "biases"):
        p[k].requires_grad_(True)
    out, bn = fn(xt, p)
    (out.float() * torch.from_numpy(r)).sum().backward()
    return out, bn, {k: p[k].grad for k in ("weights", "scales", "biases")}, \
        xt.grad


def test_fused_block_matches_unfused_chain():
    """fused_stem_block (bf16 conv + the fused op) against the port's
    unfused conv_block_train + maxpool: the same statistics code, so the
    pooled output and the rolling statistics are bit-equal; darknet's BN
    backward is folded to c1..c3 in other roundings, so the gradients
    agree at 1e-2 of their largest magnitude (the input's through the bf16
    conv backward)."""
    spec, x, params = _conv_case()
    r = np.random.default_rng(5).normal(
        0, 1, (8, 16, 6, 6)).astype(np.float32)

    def chain(v, p):
        y, bn = C.conv_block_train(v, p, spec, compute_dtype=torch.bfloat16)
        return P.maxpool(y, size=2, stride=2, pad=0), bn

    of, bnf, gf, gxf = _block_grads(
        lambda v, p: TFS.fused_stem_block(v, p, spec), x, params, r)
    oc, bnc, gc, gxc = _block_grads(chain, x, params, r)
    assert of.dtype == torch.bfloat16 and torch.equal(of, oc)
    for k in bnf:
        assert torch.equal(bnf[k], bnc[k]), k
    for k, a, b in [*((k, gf[k], gc[k]) for k in gf), ("x", gxf, gxc)]:
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-2 * scale, k


def test_fused_stem_in_network_train_forward():
    """Network(fused_stem=True): pairs 0, 2, 4, 6 and 8 fused (layer 10's
    pool has stride 1), and with phase_train the pair takes layer 0; the
    pool outputs are kept, the conv outputs never; the head input and the
    rolling statistics as the unfused network's."""
    spec = TZ.tiny_yolo_voc(width=64, height=64)
    params = params_to_torch(spec, init_params(spec, seed=2), "cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(
        2, 64, 64, 3).astype(np.float32))
    fused = Network(spec, params, compute_dtype=torch.bfloat16,
                    fused_stem=True)
    both = Network(spec, params, compute_dtype=torch.bfloat16,
                   phase_train=True, fused_stem=True)
    plain = Network(spec, params, compute_dtype=torch.bfloat16)
    assert fused.fusable == {0, 2, 4, 6, 8} and both.phase_pair
    assert not Network(spec, params, fused_stem=True).fusable
    _, af = fused(x, keep_all=True, train=True)
    _, ab = both(x, keep_all=True, train=True)
    _, ap = plain(x, keep_all=True, train=True)
    assert not {0, 2, 4, 6, 8} & set(af["outputs"])
    assert {1, 3, 5, 7, 9} <= set(af["outputs"]) and 2 not in ab["outputs"]
    for i in (9, 13):
        np.testing.assert_array_equal(af["outputs"][i].float().numpy(),
                                      ap["outputs"][i].float().numpy())
    # the same statistics code on the same conv outputs: the plain F2
    # writes y's memory format, as the kernel does, so every conv of the
    # fused network sums in the unfused network's order
    for k in ("rolling_mean", "rolling_variance"):
        for i in (0, 2, 8):
            np.testing.assert_allclose(af["bn"][i][k].numpy(),
                                       ap["bn"][i][k].numpy(), rtol=1e-5,
                                       atol=1e-6)
