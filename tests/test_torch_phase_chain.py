"""The opt-in two-pair chain (``phase_train="chain"``): kernel 4's modes
red and dy and the dgrad kernel (kernels/phase_train.py) against the JAX
package's Pallas kernels in interpret mode (as tests/test_phase_train.py
runs them), the chain against the JAX ``phase_train_chain2`` and against
a float64 evaluation of the unfused chain's formulas.

On the CPU the kernel wrappers take their plain versions, so these tests
pin the chain's arithmetic; tests/test_torch_cuda.py holds the CUDA
kernels to the plain versions on the card.

Tie rule: red and dy route each window's pooled cotangent to the first
tap attaining the maximum of the recomputed bf16 BN + bias + leaky
activation (phase_train.py:498-512 of the JAX package) — the unfused
chain's rule — and not by fwdstats' raw-extreme argmax, which pair 0's
bwdg keeps (ROADMAP queue 3, item 4). The JAX chain runs pair 0's
backward in mode "bwd" (the recomputed rule); the port runs bwdg on the
argmax its forward saved, so pair 0's gradients differ where the two
rules part, which the JAX chain test's own gates (max 9e-2, mean 2e-2 of
the largest magnitude) cover.
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


@pytest.fixture
def interpret():
    JPT._INTERPRET = True
    yield
    JPT._INTERPRET = False


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bf16(a):
    """float32 numpy array rounded to bf16 values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _from_pm(a, h, w, c):
    """The JAX dy/dgrad phase-major layout (2, H*C, (W/2)*128) -> NHWC."""
    t = np.asarray(a, np.float32).reshape(2, h, c, w // 2, 128)
    return np.transpose(t, (4, 1, 3, 0, 2)).reshape(128, h, w, c)


def _to_pm(x):
    b, h, w, c = x.shape
    return jnp.transpose(x.reshape(b, h, w // 2, 2, c),
                         (3, 1, 4, 2, 0)).reshape(2, h * c, (w // 2) * b)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_red_dy_dgrad_match_jax_pallas(interpret):
    """(128, 16, 16, 16 -> 32), the chain's second pair at a small size:
    red's sums and dy's weight gradient at rel 2e-2, dy within one bf16
    ulp with the same routing pattern, dgrad at rel 2e-2
    (tests/test_phase_train.py:209-232). x and w sit on a coarse grid
    where the bf16 conv's float32 sums are exact, so both sides recompute
    the same y and route every window alike."""
    b, h, cin, cout = 128, 16, 16, 32
    rng = np.random.default_rng(0)
    x = np.round(rng.uniform(0, 1, (b, h, h, cin)) * 8) / 8
    w = np.round(rng.normal(0, 0.3, (3, 3, cin, cout)) * 16) / 16
    scales = rng.uniform(0.6, 1.4, cout).astype(np.float32)
    scales[1] = -0.8
    biases = rng.normal(0, 0.2, cout).astype(np.float32)
    dp = _bf16(rng.normal(0, 1, (b, h // 2, h // 2, cout)))
    c1 = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    c2, c3 = (rng.normal(0, 1e-3, cout).astype(np.float32) for _ in "ab")
    xt, wt, dpt = (_t(a, torch.bfloat16) for a in (x, w, dp))
    _, _, st = TPT.fwdstats_plain(xt, wt, torch.zeros(cout), _t(scales))
    mean, _, inv = TPT._batch_stats(st, torch.zeros(cout), b * h * h)

    g = JPT.plan_pair(h, h, cin, cout, P=2)
    xp = JPT.to_phase_np(jnp.asarray(x, jnp.bfloat16), g.P)
    halo = JPT.halo_rows(xp, g.H, g.C, g.RP, g.NB)
    wpk = JPT._pack_w(jnp.asarray(w, jnp.float32), g)
    bias_b = jnp.asarray(biases).astype(jnp.bfloat16).reshape(-1, 1)
    dpp = JPT.to_phase_np(jnp.asarray(dp, jnp.bfloat16), 1)
    m, iv, sc = (jnp.asarray(a.numpy()) for a in (mean, inv, _t(scales)))
    s_j = np.asarray(JPT._run("red", g, xp, halo, wpk,
                              JPT._consts(m, m, iv, sc), bias_b, dp=dpp))
    s_j = s_j.sum(axis=1).reshape(2, cout)
    kc7 = JPT._consts(m, m, iv, sc, *map(jnp.asarray, (c1, c2, c3)))
    dy3, raw = JPT._run("dy", g, xp, halo, wpk, kc7, bias_b, dp=dpp,
                        with_wgrad=True)
    dy_j = _from_pm(dy3, h, h, cout)
    dw_j = np.asarray(JPT._unpack_dw_direct(raw, g))

    args = (xt, wt, dpt, mean, inv, _t(scales), _t(biases))
    s_t = TPT.red_plain(*args).numpy()
    dy_t, dw_t = TPT.dy_plain(*args, _t(c1), _t(c2), _t(c3))
    dy_t = dy_t.float().numpy()
    assert _rel(s_t, s_j) < 2e-2 and _rel(dw_t.numpy(), dw_j) < 2e-2
    assert_bf16_close(dy_t, dy_j)
    np.testing.assert_array_equal(dy_t != 0, dy_j != 0)
    # every window routes its cotangent somewhere; c2, c3 fill the rest
    assert (dy_t != 0).mean() > 0.99

    dg = JPT.plan_dgrad(h, h, cin, cout)
    d = _bf16(rng.normal(0, 1, (b, h, h, cout)))
    dx_j = _from_pm(JPT._run_dgrad(dg, _to_pm(jnp.asarray(d, jnp.bfloat16)),
                                   jnp.asarray(w, jnp.float32)), h, h, cin)
    dx_t = TPT.dgrad_plain(_t(d, torch.bfloat16), wt).float().numpy()
    assert _rel(dx_t, dx_j) < 2e-2


def test_dgrad_matches_jax_pallas_at_cin8(interpret):
    """dgrad at its other width, (128, 16, 16, Cout 48 -> Cin 8), against
    the JAX _run_dgrad in interpret mode at the same rel 2e-2 as above."""
    b, h, cin, cout = 128, 16, 8, 48
    rng = np.random.default_rng(8)
    w = np.round(rng.normal(0, 0.3, (3, 3, cin, cout)) * 16) / 16
    d = _bf16(rng.normal(0, 1, (b, h, h, cout)))
    dg = JPT.plan_dgrad(h, h, cin, cout)
    assert dg is not None
    dx_j = _from_pm(JPT._run_dgrad(dg, _to_pm(jnp.asarray(d, jnp.bfloat16)),
                                   jnp.asarray(w, jnp.float32)), h, h, cin)
    dx_t = TPT.dgrad_plain(_t(d, torch.bfloat16),
                           _t(w, torch.bfloat16)).float().numpy()
    assert _rel(dx_t, dx_j) < 2e-2


def _pair_case(h, cin, cout, seed):
    """tests/test_phase_train.py's _mkpair: (JAX spec, port spec, params,
    x at batch 128)."""
    rng = np.random.RandomState(seed)
    kw = dict(index=0, h=h, w=h, c=cin, inputs=h * h * cin, out_h=h,
              out_w=h, out_c=cout, outputs=h * h * cout, size=3, stride=1,
              pad=1, filters=cout, activation="leaky", batch_normalize=True)
    params = {
        "weights": rng.randn(3, 3, cin, cout).astype(np.float32) * 0.3,
        "biases": rng.randn(cout).astype(np.float32) * 0.1,
        "scales": 1.0 + 0.2 * rng.randn(cout).astype(np.float32),
        "rolling_mean": 0.05 * rng.randn(cout).astype(np.float32),
        "rolling_variance": 1.0 + 0.1 * rng.rand(cout).astype(np.float32),
    }
    x = rng.rand(128, h, h, cin).astype(np.float32)
    return JS.ConvSpec(**kw), S.ConvSpec(**kw), params, x


def _torch_params(params):
    out = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    out["weights"] = out["weights"].permute(3, 2, 0, 1).contiguous()
    for k in ("weights", "scales", "biases"):
        out[k].requires_grad_(True)
    return out


def test_chain_matches_jax_chain2(interpret):
    """The port's chain against JAX phase_train_chain2 at the JAX test's
    geometry and gates (tests/test_phase_train.py:240-282): the loss at
    3e-2, the rolling statistics at 2e-3, every gradient of both pairs at
    max 9e-2 / mean 2e-2 of its largest magnitude."""
    js0, s0, p0, x = _pair_case(16, 3, 16, seed=0)
    js2, s2, p2, _ = _pair_case(8, 16, 32, seed=1)
    r = np.random.RandomState(9).randn(128, 4, 4, 32).astype(np.float32)

    def loss_j(ps):
        y, bn0, bn2 = JPT.phase_train_chain2(jnp.asarray(x), ps[0], js0,
                                             ps[1], js2)
        return jnp.sum(y.astype(jnp.float32) * r), (bn0, bn2)

    (lj, bnj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree.map(jnp.asarray, (p0, p2)))
    tp = (_torch_params(p0), _torch_params(p2))
    y, bn0, bn2 = TPT.phase_train_chain2(torch.from_numpy(x), tp[0], s0,
                                         tp[1], s2)
    assert y.dtype == torch.bfloat16 and y.shape == (128, 4, 4, 32)
    lt = (y.float() * torch.from_numpy(r)).sum()
    lt.backward()
    assert abs(lt.item() - float(lj)) < 3e-2 * max(1.0, abs(float(lj)))
    for bt, bj in zip((bn0, bn2), bnj):
        for k in ("rolling_mean", "rolling_variance"):
            np.testing.assert_allclose(bt[k].detach().numpy(),
                                       np.asarray(bj[k]), rtol=2e-3,
                                       atol=2e-3)
    for pi in (0, 1):
        for k in ("weights", "scales", "biases"):
            a = tp[pi][k].grad.numpy()
            if k == "weights":
                a = np.transpose(a, (2, 3, 1, 0))
            b = np.asarray(gj[pi][k])
            d = np.abs(a - b) / max(1e-3, float(np.abs(b).max()))
            assert d.max() < 9e-2 and d.mean() < 2e-2, (pi, k, d.max(),
                                                         d.mean())


@pytest.mark.parametrize("b,h", [(16, 16), (4, 40)])
def test_dx_pair_matches_float64_chain(b, h):
    """The chain's second pair (phase_train_dx_block) against a float64
    evaluation of the unfused chain's formulas, its input gradient
    included (torch_parity.check_pair_gradient): weights, scales and
    biases at 1e-3, the bf16 input gradient at 1e-2 of its largest
    magnitude. 40 x 40 leaves partial 8 x 8 pooled tiles."""
    spec = S.ConvSpec(index=2, h=h, w=h, c=16, inputs=h * h * 16, out_h=h,
                      out_w=h, out_c=32, outputs=h * h * 32, size=3,
                      stride=1, pad=1, filters=32, activation="leaky",
                      batch_normalize=True)
    res = check_pair_gradient(TPT, C, P, spec,
                              train_case(b + h, b, h, 16, 32, "cpu",
                                         flat=False), dx=1e-2)
    assert res["masked"] == 0.0, res       # one rule on one conv on the CPU
    assert res["fused"] <= 1e-3 and res["dx"] <= 1e-2, res


@pytest.mark.parametrize("size", [320 + 32 * i for i in range(10)])
def test_chain_engages_at_every_multiscale_size(size):
    """detector train resizes tiny-yolo-voc (random=1) to 320..608: the
    chain engages at each size, and not without bf16 or its flag."""
    spec = TZ.tiny_yolo_voc().resize(size, size)
    params = params_to_torch(spec, init_params(spec, seed=0), "cpu")
    net = Network(spec, params, compute_dtype=torch.bfloat16,
                  phase_train="chain")
    assert net.phase_pair and net.phase_chain
    l0, l2 = spec.layers[0], spec.layers[2]
    assert TPT.supported_chain(l0, l2) and size % 4 == 0
    assert (l2.h, l2.c, l2.filters) == (size // 2, 16, 32)
    assert not Network(spec, params, compute_dtype=torch.bfloat16,
                       phase_train=True).phase_chain
    assert not Network(spec, params, phase_train="chain").phase_chain


def test_chain_runs_through_network_train_forward():
    """Network.forward(train=True) with the chain: the same layer-3 output
    and rolling statistics as the unfused network, and no output of layers
    0-2 (neither full-resolution activation is formed)."""
    spec = TZ.tiny_yolo_voc(width=32, height=32)
    params = params_to_torch(spec, init_params(spec, seed=2), "cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(
        4, 32, 32, 3).astype(np.float32))
    chain = Network(spec, params, compute_dtype=torch.bfloat16,
                    phase_train="chain")
    plain = Network(spec, params, compute_dtype=torch.bfloat16)
    _, ac = chain(x, keep_all=True, train=True)
    _, ap = plain(x, keep_all=True, train=True)
    assert not {0, 1, 2} & set(ac["outputs"]) and 3 in ac["outputs"]
    assert_bf16_close(ac["outputs"][3].float().numpy(),
                      ap["outputs"][3].float().numpy())
    for i in (0, 2):
        for k in ("rolling_mean", "rolling_variance"):
            np.testing.assert_allclose(ac["bn"][i][k].numpy(),
                                       ap["bn"][i][k].numpy(), rtol=1e-5)
