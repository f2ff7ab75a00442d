"""The port's training main path against the C-oracle goldens and the
JAX package: the float32 Trainer, the region loss, the SGD update and
the learning-rate policies, the bf16 phase_train step, nan_guarded.

JAX runs on the CPU (its Pallas pair in interpret mode, as
tests/test_phase_train.py runs it); the port runs on the CPU, where the
kernel wrappers take their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.train import region_loss as JRL
from sr_object_detection_tpu.train import sgd as JSGD
from sr_object_detection_tpu.train.trainer import (TrainState as JState,
                                                   make_train_step as j_step)
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.train import region_loss as TRL
from sr_object_detection_tpu_torch.train import sgd as TSGD
from sr_object_detection_tpu_torch.train.trainer import (Trainer,
                                                         nan_guarded)
from torch_parity import TRAIN_GOLDENS, check_train_golden

@pytest.mark.parametrize("name", sorted(TRAIN_GOLDENS))
def test_trainer_matches_c_oracle(name):
    """The float32 Trainer reproduces the reference's weights after N SGD
    steps and its cost trajectory (tests/test_train_parity.py's gates)."""
    check_train_golden(name, "cpu")


def _region_case(seed, classfix=0, rescore=True, b=3, h=4, w=5):
    kw = dict(index=0, n=3, classes=4, coords=4,
              anchors=(1.0, 1.5, 2.5, 2.0, 4.0, 4.5), softmax=True, h=h, w=w,
              coord_scale=1.5, object_scale=5.0, noobject_scale=1.0,
              class_scale=1.0, thresh=0.3, rescore=rescore,
              classfix=classfix, bias_match=True)
    rng = np.random.RandomState(seed)
    raw = rng.randn(b, h * w * 3 * 9).astype(np.float32)
    truth = np.zeros((b, 30, 5), np.float32)
    for i in range(b):
        for t in range(rng.randint(1, 6)):
            truth[i, t] = [rng.uniform(.05, .95), rng.uniform(.05, .95),
                           rng.uniform(.05, .6), rng.uniform(.05, .6),
                           rng.randint(0, 4)]
    return JS.RegionSpec(**kw), S.RegionSpec(**kw), raw, truth


@pytest.mark.parametrize("seed,classfix,rescore,seen", [
    (0, 0, True, 100), (1, 2, True, 20000), (2, 1, False, 20000),
    (3, -1, True, 500)])
def test_region_delta_matches_jax(seed, classfix, rescore, seen):
    js, ts, raw, truth = _region_case(seed, classfix, rescore)
    ja, jd, jst = JRL.region_delta(jnp.asarray(raw), jnp.asarray(truth),
                                   seen, js)
    ta, td, tst = TRL.region_delta(torch.from_numpy(raw),
                                   torch.from_numpy(truth), seen, ts)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the custom gradient: d cost / d raw = -delta
    raw_t = torch.from_numpy(raw).requires_grad_(True)
    loss, _ = TRL.make_region_loss(ts)
    cost = loss(raw_t, torch.from_numpy(truth), seen)
    cost.backward()
    np.testing.assert_allclose(raw_t.grad.numpy(), -td.numpy())
    np.testing.assert_allclose(cost.item(), float((td ** 2).sum()),
                               rtol=1e-6)


def test_region_padding_rows_cannot_clobber_cell0():
    """A real truth assigned to (cell 0,0, anchor 0) keeps its deltas:
    the padding rows that hash to the same cell are dropped
    (tests/test_train_parity.py's case, held against JAX)."""
    kw = dict(index=0, n=2, classes=3, coords=4, anchors=(1.0, 1.0, 3.0, 3.0),
              softmax=True, h=2, w=2, coord_scale=2.0, object_scale=5.0,
              noobject_scale=1.0, class_scale=1.0)
    raw = np.random.RandomState(0).randn(1, 2 * 2 * 2 * 8).astype(np.float32)
    truth = np.zeros((1, 30, 5), np.float32)
    truth[0, 0] = [0.2, 0.2, 0.5, 0.5, 1]
    _, jd, _ = JRL.region_delta(jnp.asarray(raw), jnp.asarray(truth), 20000,
                                JS.RegionSpec(**kw))
    _, td, _ = TRL.region_delta(torch.from_numpy(raw),
                                torch.from_numpy(truth), 20000,
                                S.RegionSpec(**kw))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(td.numpy().reshape(2, 2, 2, 8)[0, 0, 0, :4]).max() > 1e-3


def test_region_loss_rejects_tree_head():
    """A tree whose node count is not the head's class count is refused;
    one that matches builds the tree loss (tests/test_torch_tree_train.py
    holds it to JAX's)."""
    import types
    _, ts, raw, truth = _region_case(0)
    tree = types.SimpleNamespace(parent=np.array([-1, -1, 0, 0, 1]),
                                 group=np.array([0, 0, 1, 1, 2]))
    with pytest.raises(ValueError, match="5 nodes"):
        TRL.make_region_loss(ts, tree=tree)
    tree.parent, tree.group = tree.parent[:4], tree.group[:4]
    _, loss_ws = TRL.make_region_loss(ts, tree=tree)
    cost, _ = loss_ws(torch.from_numpy(raw), torch.from_numpy(truth), 0)
    flat, _ = TRL.make_region_loss(ts)[1](torch.from_numpy(raw),
                                          torch.from_numpy(truth), 0)
    assert torch.isfinite(cost) and float(cost) != float(flat)


def test_sgd_update_matches_jax():
    rng = np.random.RandomState(0)
    shapes = [{"weights": (3, 3, 2, 4), "biases": (4,), "scales": (4,),
               "rolling_mean": (4,), "rolling_variance": (4,)},
              {}, {"weights": (1, 1, 4, 5), "biases": (5,)}]
    p, g, v = ([{k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
                for d in shapes] for _ in range(3))
    jp, jv = JSGD.sgd_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        jax.tree.map(jnp.asarray, v), lr=jnp.float32(0.01), batch_size=64,
        momentum=0.9, decay=0.0005)
    t = [[{k: torch.from_numpy(a) for k, a in d.items()} for d in tree]
         for tree in (p, g, v)]
    tp, tv = TSGD.sgd_update(*t, lr=0.01, batch_size=64, momentum=0.9,
                             decay=0.0005)
    for i, d in enumerate(shapes):
        for k in d:
            np.testing.assert_allclose(tp[i][k].numpy(), np.asarray(jp[i][k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tv[i][k].numpy(), np.asarray(jv[i][k]),
                                       rtol=1e-6, atol=1e-7)
    # rolling statistics are left as they are
    assert tp[0]["rolling_mean"] is t[0][0]["rolling_mean"]


@pytest.mark.parametrize("t", [1, 7])
def test_adam_update_matches_jax(t):
    rng = np.random.RandomState(t)
    w, g, m = (rng.randn(3, 3, 2, 4).astype(np.float32) for _ in range(3))
    v = rng.rand(3, 3, 2, 4).astype(np.float32)
    kw = dict(lr=0.001, batch_size=64, decay=0.0005, t=t)
    want = JSGD.adam_update(*map(jnp.asarray, (w, g, m, v)), **kw)
    got = TSGD.adam_update(*map(torch.from_numpy, (w, g, m, v)), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("policy,extra", [
    ("constant", {}), ("step", {"step": 7, "scale": 0.5}),
    ("steps", {"steps": (5, 20, 12), "scales": (0.1, 10.0, 0.5)}),
    ("exp", {"gamma": 0.99}),
    ("poly", {"power": 4.0, "burn_in": 10, "max_batches": 100}),
    ("sigmoid", {"gamma": 0.2, "step": 30})])
def test_learning_rate_policies_match_jax(policy, extra):
    jnet = dataclasses.replace(JZ.tiny_yolo_voc().net, policy=policy,
                               learning_rate=0.01, **extra)
    tnet = dataclasses.replace(TZ.tiny_yolo_voc().net, policy=policy,
                               learning_rate=0.01, **extra)
    for bn in (0, 3, 6, 11, 25, 60, 99):
        np.testing.assert_allclose(TSGD.learning_rate(tnet, bn),
                                   float(JSGD.learning_rate(jnet, bn)),
                                   rtol=2e-6)
        if policy != "random":
            assert TSGD.learning_rate_py(tnet, bn) == \
                JSGD.learning_rate_py(jnet, bn)


def _bf16_spec(mod, size=32):
    base = mod.tiny_yolo_voc(width=size, height=size)
    return dataclasses.replace(
        base, net=dataclasses.replace(base.net, batch=128, subdivisions=1))


def _bf16_batch():
    x = np.random.RandomState(0).rand(128, 32, 32, 3).astype(np.float32)
    t = np.zeros((128, 30, 5), np.float32)
    t[:, 0] = [0.5, 0.5, 0.4, 0.4, 2]
    return x, t


def test_bf16_phase_train_step_matches_jax():
    """The bf16 Trainer with phase_train=True against the JAX bf16 step
    with phase_train=True (its Pallas pair in interpret mode) on
    tiny-yolo-voc at 32x32, batch 128: the first loss within
    0.03*|loss| + 0.05 (tests/test_phase_train.py:163-165), and the
    second loss below the first."""
    x, t = _bf16_batch()
    jspec = _bf16_spec(JZ)
    params = j_init_params(jspec, seed=0)
    JPT._INTERPRET = True
    try:
        jp = jax.tree.map(jnp.asarray, params)
        st = JState(jp, jax.tree.map(jnp.zeros_like, jp), jnp.asarray(0))
        step = jax.jit(j_step(jspec, compute_dtype=jnp.bfloat16,
                              phase_train=True))
        _, m = step(st, jnp.asarray(x), jnp.asarray(t),
                    jax.random.PRNGKey(0))
        j_loss = float(m["loss"])
    finally:
        JPT._INTERPRET = False
    tr = Trainer(_bf16_spec(TZ), params=params, device="cpu",
                 compute_dtype=torch.bfloat16, phase_train=True)
    l1 = float(tr.step(x, t)["loss"])
    l2 = float(tr.step(x, t)["loss"])
    assert abs(l1 - j_loss) <= 0.03 * abs(j_loss) + 0.05, (l1, j_loss)
    assert l2 < l1


def test_bf16_input_equals_float32_input():
    """Trainer.step takes float32 or bf16 NHWC: a bf16 input is the same
    step as a float32 input cast at the pair (the JAX device-aug
    dataflow, bench.py:279-283)."""
    x, t = _bf16_batch()
    spec = _bf16_spec(TZ)
    spec = dataclasses.replace(spec, net=dataclasses.replace(spec.net,
                                                             batch=16))
    params = init_params(spec, seed=1)
    xb = torch.from_numpy(x[:16]).to(torch.bfloat16)
    out = []
    for xin in (xb.float().numpy(), xb):
        tr = Trainer(spec, params=params, device="cpu",
                     compute_dtype=torch.bfloat16, phase_train=True)
        m = tr.step(xin, t[:16])
        out.append((float(m["loss"]), tr.state.params[0]["weights"]))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])


def test_nan_guarded_keeps_state_on_poisoned_input():
    spec = _bf16_spec(TZ)
    spec = dataclasses.replace(spec, net=dataclasses.replace(spec.net,
                                                             batch=2))
    tr = Trainer(spec, device="cpu")
    step = nan_guarded(tr._steps[(32, 32)])
    x, t = _bf16_batch()
    x = torch.from_numpy(x[:2].copy())
    t = torch.from_numpy(t[:2])
    before = tr.state
    x[0, 3, 3, 1] = float("nan")
    st, m = step(before, x, t)
    assert m["skipped_nonfinite"] and st is before
    st, m = step(before, torch.zeros_like(x), t)
    assert not m["skipped_nonfinite"] and int(st.seen) == 2
    assert not torch.equal(st.params[0]["weights"],
                           before.params[0]["weights"])


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "item 11")])
def test_trainer_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Trainer(_bf16_spec(TZ), device="cpu", **kw)


@pytest.mark.parametrize("kw,fused", [
    ({"phase_train": "chain"}, set()), ({"fused_stem": True}, {0, 2, 4, 6, 8}),
    ({"phase_train": True, "fused_stem": True}, {2, 4, 6, 8}),
    ({"phase_train": "chain", "fused_stem": True}, {4, 6, 8})])
def test_bf16_kernel_options_step_like_unfused(kw, fused):
    """The opt-in bf16 training paths on tiny-yolo-voc at 32x32, batch
    128: the network takes the layers the options name (the pair or chain
    first, the fused stem on every later fusable pair; layer 10's pool has
    stride 1), the first loss lies within 0.03*|loss| + 0.05 of the
    unfused bf16 step's (tests/test_phase_train.py:336-338) and the second
    below the first."""
    x, t = _bf16_batch()
    spec = _bf16_spec(TZ)
    params = init_params(spec, seed=0)
    net = Network(spec, params_to_torch(spec, params, "cpu"),
                  compute_dtype=torch.bfloat16, **kw)
    start = 4 if net.phase_chain else 2 if net.phase_pair else 0
    assert net.phase_chain == (kw.get("phase_train") == "chain")
    assert {i for i in net.fusable if i >= start} == fused
    plain = Trainer(spec, params=params, device="cpu",
                    compute_dtype=torch.bfloat16)
    want = float(plain.step(x, t)["loss"])
    tr = Trainer(spec, params=params, device="cpu",
                 compute_dtype=torch.bfloat16, **kw)
    l1 = float(tr.step(x, t)["loss"])
    l2 = float(tr.step(x, t)["loss"])
    assert abs(l1 - want) <= 0.03 * abs(want) + 0.05, (l1, want)
    assert l2 < l1
