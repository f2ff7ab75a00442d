"""The port's training forward through route, reorg and shortcut, and
``remat``, against the JAX package on the CPU.

* ``Network(train=True)`` against the JAX ``build_forward(train=True)``
  in float32 on the ``mini_route_reorg`` spec (route -2, reorg 2, route
  -1,-3 and a strided shortcut) and the ``map_ab_v2`` spec (96x96, route
  -3, reorg 2, route -1,-3 before the region head): the output and the
  gradient of a fixed cotangent, at rtol 1e-5 with an atol of 1e-5 of
  each tensor's largest magnitude;
* the float32 ``Trainer`` on ``map_ab_v2`` against the JAX trainer, two
  steps of two subdivisions: every parameter within 2e-4 (the C-oracle
  training goldens' gate);
* on a narrow yolov2-topology spec (3x3 pairs, a live layer read by a
  route, reorg, a two-source route, a shortcut): the bf16 step without
  kernels against the JAX bf16 step (the loss at the bf16 training
  gate, the parameters at 2^-7; ROADMAP queue 3, item 5) and the kernel
  options against the port's unfused bf16 step, with the fused set (the
  live layer left out);
* ``remat=False``, ``True``, ``"selective"`` and ``"selective:2"`` give
  bit-identical losses, velocities (the summed gradients) and parameters
  over two steps, in float32 and in bf16 with ``phase_train=True`` and
  ``fused_stem=True``; ``"selective:k"`` checkpoints exactly the layers
  whose outputs the JAX trainer's policy does not save.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.train.trainer as JT
from sr_object_detection_tpu.config import parse_cfg_text as j_parse
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.graph.compiler import build_forward
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.models.zoo import CfgBuilder as JCfgBuilder
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import (
    Network, remat_saved)
from sr_object_detection_tpu_torch.io.convert import (params_to_numpy,
                                                      params_to_torch)
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import random_bn

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GRAD_RTOL = 1e-5          # float32 forward and gradients against JAX


def _specs(text, batch=None, subdivisions=None):
    """(port spec, JAX spec) of one cfg text, [net] batch/subdivisions
    replaced where given."""
    out = []
    for parse, build in ((parse_cfg_text, S.build_network_spec),
                         (j_parse, JS.build_network_spec)):
        spec = build(parse(text))
        net = spec.net
        if batch is not None:
            net = dataclasses.replace(net, batch=batch)
        if subdivisions is not None:
            net = dataclasses.replace(net, subdivisions=subdivisions)
        out.append(dataclasses.replace(spec, net=net))
    return out


def _golden_text(name):
    return bytes(np.load(GOLDEN / f"{name}.npz")["cfg"]).decode()


def narrow_yolov2_text(size=32, classes=3):
    """yolov2's topology, narrow: 3x3 conv + maxpool pairs (3 -> 32
    first, so the chain refuses layer 2 at Cin 32 as on yolov2), layer 4 live
    (read by route -4), a 1x1 conv and reorg 2, a two-source route, a
    3x3 conv, a shortcut from layer 6, the 1x1 head and the region."""
    b = JCfgBuilder()
    b.net(batch=8, subdivisions=1, width=size, height=size, channels=3,
          momentum=0.9, decay=0.0005, learning_rate=0.001,
          max_batches=100, policy="constant")
    b.conv(32)                                   # 0 @32: the pair
    b.maxpool()                                  # 1
    b.conv(16)                                   # 2 @16: fusable
    b.maxpool()                                  # 3
    b.conv(32)                                   # 4 @8: live
    b.maxpool()                                  # 5
    b.conv(32)                                   # 6 @4: live
    b.conv(16, size=1, pad=1)                    # 7
    b.section("route", layers=-4)                # 8: layer 4
    b.conv(8, size=1, pad=1)                     # 9 @8
    b.section("reorg", stride=2)                 # 10 -> 4x4x32
    b.section("route", layers=(-1, -4))          # 11: layers 10, 7
    b.conv(32)                                   # 12
    b.section("shortcut", **{"from": -7}, activation="leaky")  # 13
    b.conv(5 * (classes + 5), size=1, bn=False, act="linear")  # 14
    b.section("region", anchors=(1, 1, 2, 2, 3, 3, 4, 4, 5, 5),
              bias_match=1, classes=classes, coords=4, num=5, softmax=1,
              jitter=.2, rescore=1, object_scale=5, noobject_scale=1,
              class_scale=1, coord_scale=1, absolute=1, thresh=.6)
    return b.text()


def _params(jspec, seed):
    return random_bn(j_init_params(jspec, seed=seed), seed, head_gain=2.0)


def _truth(b):
    t = np.zeros((b, 30, 5), np.float32)
    t[:, 0] = [0.4, 0.6, 0.3, 0.4, 1]
    t[::2, 1] = [0.7, 0.3, 0.2, 0.2, 2]
    return t


def _head_input(spec):
    """The layer the training loss reads: the region head's input, else
    the output layer."""
    last = len(spec.layers) - 1
    return last - 1 if type(spec.layers[last]).__name__ == "RegionSpec" \
        else last


def _torch_grads(spec, params, x, g, dtype=torch.float32, **kw):
    """The port's training forward up to the layer the loss reads and the
    gradient of sum(out * g) with respect to every parameter (HWIO
    numpy, as the JAX grads); ``dtype`` the parameters' and input's."""
    tp = params_to_torch(spec, params, "cpu", dtype=dtype)
    for p in tp:
        for k, v in p.items():
            if k not in ("rolling_mean", "rolling_variance"):
                v.requires_grad_(True)
    net = Network(spec, tp, **kw)
    out, _ = net(torch.from_numpy(x).to(dtype), train=True, params=tp,
                 want=(_head_input(spec),))
    (out.to(dtype) * torch.from_numpy(g).to(dtype)).sum().backward()
    grads = params_to_numpy(spec, [
        {k: (v.grad if v.grad is not None else torch.zeros_like(v))
         for k, v in p.items()} for p in tp])
    return out.float().detach().numpy(), grads


def _jax_grads(jspec, params, x, g, **kw):
    fwd = build_forward(jspec, **kw)
    idx = _head_input(jspec)

    def f(p):
        _, aux = fwd(p, jnp.asarray(x), train=True, keep_all=True)
        out = aux["outputs"][idx]
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return (np.asarray(out, np.float32),
            jax.tree.map(lambda a: np.asarray(a, np.float32), grads))


def _assert_grads(got, want, rel, rtol=0.0):
    """Every gradient tensor within ``rel`` of its largest magnitude (and
    ``rtol`` of each element)."""
    n = 0
    for i, wp in enumerate(want):
        for k, w in wp.items():
            if k in ("rolling_mean", "rolling_variance"):
                continue
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[i][k], w, rtol=rtol,
                                       atol=rel * scale,
                                       err_msg=f"layer {i} {k}")
            n += 1
    assert n > 0


@pytest.mark.parametrize("name,batch", [("mini_route_reorg", 3),
                                        ("map_ab_v2", 2)])
def test_train_forward_and_grads_match_jax(name, batch):
    """float32: the training forward through route, reorg and shortcut
    (up to the layer the loss reads: the region head's input, or the
    shortcut's output) and its gradients (autograd's split of the concat, the transposed
    reorg gather, the resampled add) against JAX value_and_grad, at
    rtol 1e-5 and an atol of 1e-5 of each tensor's largest value. The
    two float32 forwards part by about 1e-6; where a pre-activation lies
    that close to 0, or a pool window's top two taps that close together,
    the two route that element's cotangent apart (a leaky slope of 0.1
    against 1, or another tap), which moves a weight gradient by up to
    1e-2 of its largest value: the cases are small (map_ab_v2 at B=2),
    and the port's float32 gradients are within 1e-5 of its own float64
    evaluation on them."""
    spec, jspec = _specs(_golden_text(name))
    params = _params(jspec, 3)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (batch, spec.net.h, spec.net.w,
                           spec.net.c)).astype(np.float32)
    shape = jax.eval_shape(
        lambda v: build_forward(jspec)(params, v, train=True, keep_all=True)[
            1]["outputs"][_head_input(jspec)],
        jax.ShapeDtypeStruct(x.shape, jnp.float32)).shape
    g = rng.normal(0, 1, shape).astype(np.float32)
    out_j, grads_j = _jax_grads(jspec, params, x, g)
    out_t, grads_t = _torch_grads(spec, params, x, g)
    _, grads_64 = _torch_grads(spec, params, x, g, dtype=torch.float64)
    kinds = {type(l).__name__ for l in spec.layers}
    assert {"RouteSpec", "ReorgSpec"} <= kinds
    _assert_grads(grads_t, grads_64, GRAD_RTOL, GRAD_RTOL)
    np.testing.assert_allclose(out_t, out_j, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(out_j).max())
    _assert_grads(grads_t, grads_j, GRAD_RTOL, GRAD_RTOL)


def test_f32_trainer_matches_jax_map_ab_v2():
    """The float32 Trainer on map_ab_v2 (batch 4, subdivisions 2) against
    the JAX trainer: two steps, the losses at 1e-5 and every parameter
    within 2e-4."""
    spec, jspec = _specs(_golden_text("map_ab_v2"), batch=4, subdivisions=2)
    params = _params(jspec, 4)
    x = np.random.default_rng(6).uniform(0, 1, (8, 96, 96, 3)).astype(
        np.float32)
    t = _truth(8)
    jp = jax.tree.map(jnp.asarray, params)
    st = JT.TrainState(jp, jax.tree.map(jnp.zeros_like, jp), jnp.asarray(0))
    step = jax.jit(JT.make_train_step(jspec))
    tr = Trainer(spec, params=params, device="cpu")
    for i in range(2):
        st, mj = step(st, jnp.asarray(x), jnp.asarray(t),
                      jax.random.PRNGKey(i))
        mt = tr.step(x, t)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
    mine = params_to_numpy(spec, tr.state.params)
    for i, want in enumerate(st.params):
        for k, v in want.items():
            np.testing.assert_allclose(mine[i][k], np.asarray(v), rtol=2e-4,
                                       atol=2e-4, err_msg=f"layer {i} {k}")


def test_bf16_step_matches_jax():
    """One bf16 step without kernels on the narrow yolov2-topology spec
    against the JAX bf16 step: the loss within 0.03*|loss| + 0.05 (the
    bf16 training gate, tests/test_phase_train.py:163-165) and every
    parameter after the step within 2^-7 of JAX's (the gate of
    tests/test_torch_slice.py). On the CPU the JAX bf16 chain keeps
    float32 precision across its bf16 round trips (ROADMAP queue 3, item
    5), so its gradients are not the port's bit for bit: up to a fifth
    of a tensor's largest gradient apart on this spec. The port's bf16
    gradients are held to a float64 evaluation on the card
    (torch_parity.check_pair_gradient)."""
    spec, jspec = _specs(narrow_yolov2_text())
    params = _params(jspec, 7)
    x = np.random.default_rng(8).uniform(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    t = _truth(8)
    jp = jax.tree.map(jnp.asarray, params)
    st = JT.TrainState(jp, jax.tree.map(jnp.zeros_like, jp), jnp.asarray(0))
    st, mj = jax.jit(JT.make_train_step(jspec, compute_dtype=jnp.bfloat16))(
        st, jnp.asarray(x), jnp.asarray(t), jax.random.PRNGKey(0))
    tr = Trainer(spec, params=params, device="cpu",
                 compute_dtype=torch.bfloat16)
    loss = float(tr.step(x, t)["loss"])
    want = float(mj["loss"])
    assert abs(loss - want) <= 0.03 * abs(want) + 0.05, (loss, want)
    mine = params_to_numpy(spec, tr.state.params)
    moved = 0
    for i, p in enumerate(st.params):
        for k, v in p.items():
            np.testing.assert_allclose(mine[i][k], np.asarray(v), rtol=0,
                                       atol=2 ** -7, err_msg=f"{i} {k}")
            moved += not np.array_equal(np.asarray(v), params[i][k])
    assert moved > 0


@pytest.mark.parametrize("kw,fused", [
    ({"phase_train": True}, set()), ({"phase_train": "chain"}, set()),
    ({"fused_stem": True}, {0, 2}),
    ({"phase_train": True, "fused_stem": True}, {2})])
def test_bf16_kernel_options_step_like_unfused(kw, fused):
    """The bf16 kernel options on the narrow yolov2-topology spec: the
    pair takes layers 0-1 (the chain refuses layer 2, and runs the pair),
    the fused stem every later fusable pair but the live layer 4's; the
    first loss within 0.03*|loss| + 0.05 of the unfused bf16 step's, the
    second below the first."""
    spec, jspec = _specs(narrow_yolov2_text())
    params = _params(jspec, 9)
    x = np.random.default_rng(10).uniform(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    t = _truth(8)
    net = Network(spec, params_to_torch(spec, params, "cpu"),
                  compute_dtype=torch.bfloat16, **kw)
    assert net.live == {4, 6, 7, 10}
    assert net.phase_pair == ("phase_train" in kw) and not net.phase_chain
    kinds = {u[2] for u in net.train_units(32, 32)}
    assert ("pair" in kinds) == ("phase_train" in kw)
    assert {u[0] for u in net.train_units(32, 32)
            if u[2] == "fused"} == fused
    plain = Trainer(spec, params=params, device="cpu",
                    compute_dtype=torch.bfloat16)
    want = float(plain.step(x, t)["loss"])
    tr = Trainer(spec, params=params, device="cpu",
                 compute_dtype=torch.bfloat16, **kw)
    l1 = float(tr.step(x, t)["loss"])
    l2 = float(tr.step(x, t)["loss"])
    assert abs(l1 - want) <= 0.03 * abs(want) + 0.05, (l1, want)
    assert l2 < l1


@pytest.mark.parametrize("kw", [
    {}, {"compute_dtype": torch.bfloat16, "phase_train": True,
         "fused_stem": True}])
def test_remat_bit_identical(kw, monkeypatch):
    """remat False, True, "selective" and "selective:2" on the narrow
    yolov2-topology spec, two steps of two subdivisions: the same
    losses, velocities (the summed gradients) and parameters bit for
    bit; the backward recomputed units exactly where a mode has
    checkpointed segments (with the pair, "selective:2" has none: the
    pair's output is layer 1's, which the policy saves)."""
    spec, jspec = _specs(narrow_yolov2_text(), batch=4, subdivisions=2)
    params = _params(jspec, 11)
    x = np.random.default_rng(12).uniform(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    t = _truth(8)
    calls = []
    run_unit = Network._run_unit

    def counted(self, *args):
        calls.append(args[0])
        return run_unit(self, *args)
    monkeypatch.setattr(Network, "_run_unit", counted)
    runs = {}
    for remat in (False, True, "selective", "selective:2"):
        tr = Trainer(spec, params=params, device="cpu", remat=remat, **kw)
        calls.clear()
        losses = [float(tr.step(x, t)["loss"]) for _ in range(2)]
        net = Network(spec, tr.state.params, **kw)
        segs = net.remat_segments(remat, 32, 32)
        runs[remat] = (losses, tr.state, len(calls), segs)
    losses, ref, base, _ = runs[False]
    assert np.isfinite(losses).all()
    assert base == 2 * 2 * len(Network(spec, ref.params, **kw).train_units(
        32, 32)[:-1])                   # the region head is not run
    for remat, (got, st, n, segs) in runs.items():
        assert got == losses, (remat, got, losses)
        assert (n > base) == bool(segs), (remat, n, base, segs)
        for a, b in ((st.params, ref.params), (st.velocity, ref.velocity)):
            for i, (pa, pb) in enumerate(zip(a, b)):
                for k in pb:
                    assert torch.equal(pa[k], pb[k]), (remat, i, k)
    assert runs["selective:2"][3] == ([] if kw else [[(0, 0, "layer")]])


def _jax_saved(jspec, remat):
    """The layer indices whose names the JAX trainer's selective policy
    saves, read off the policy it builds."""
    names = []
    real = jax.checkpoint_policies.save_only_these_names

    def spy(*ns):
        names.extend(ns)
        return real(*ns)
    jax.checkpoint_policies.save_only_these_names = spy
    try:
        JT.make_train_step(jspec, remat=remat)
    finally:
        jax.checkpoint_policies.save_only_these_names = real
    return {int(n[len("layer"):-len("_out")]) for n in names}


@pytest.mark.parametrize("cfg,remat", [
    ("narrow", "selective"), ("narrow", "selective:2"),
    ("narrow", "selective:4"), ("map_ab_v2", "selective"),
    ("map_ab_v2", "selective:2"), ("yolov2-608", "selective:2"),
    ("yolov2-608", "selective")])
def test_selective_segments_are_jax_unsaved_layers(cfg, remat):
    """Without kernel units, the layers that "selective:k" runs in
    checkpointed segments are exactly those outside the JAX policy's
    saved names (remat_saved is that set), each segment a run of
    consecutive layers; with the fused pair at 608, "selective:2"
    checkpoints nothing (the pair's pooled output is layer 1's, which
    the policy saves) and "selective" the units up to layer 5."""
    if cfg == "yolov2-608":
        from sr_object_detection_tpu.models.zoo import yolov2 as j_yolov2
        from sr_object_detection_tpu_torch.models.zoo import yolov2
        spec, jspec = yolov2(608, 608), j_yolov2(608, 608)
    else:
        text = (narrow_yolov2_text() if cfg == "narrow"
                else _golden_text(cfg))
        spec, jspec = _specs(text)
    saved = _jax_saved(jspec, remat)
    k = int(remat.split(":")[1]) if ":" in remat else 8
    assert remat_saved(spec, k) == saved
    empty = [{} for _ in spec.layers]
    net = Network(spec, empty)
    h, w = spec.net.h, spec.net.w
    segs = net.remat_segments(remat, h, w)
    got = [i for seg in segs for u in seg for i in range(u[0], u[1] + 1)]
    assert sorted(got) == sorted(set(range(len(spec.layers))) - saved)
    assert all(seg[-1][1] + 1 not in got for seg in segs)
    assert [[u] for u in net.train_units(h, w)] == net.remat_segments(
        True, h, w)
    if cfg == "yolov2-608":
        kn = Network(spec, empty, compute_dtype=torch.bfloat16,
                     phase_train=True, fused_stem=True)
        assert sorted(kn.fusable) == [0, 2, 6, 10]
        ks = kn.remat_segments(remat, h, w)
        assert ks == ([] if k == 2 else [[
            (0, 1, "pair"), (2, 3, "fused"), (4, 4, "layer"),
            (5, 5, "layer")]])
