"""The port's yolov2 forward on the CPU: route, reorg and shortcut.

* ``ops/layout``'s reorg (both directions, NHWC and NCHW forms), route
  and shortcut against the JAX module's: equal;
* ``Network`` against the C-oracle goldens ``mini_route_reorg.npz``
  (route, reorg and a strided shortcut; every layer and the output at
  the reference's 2e-5) and ``yolo_coco_416.npz`` (yolov2 at full width
  and 416, 2e-4: tests/test_parity.py's gates);
* ``Network`` layer by layer against the JAX ``build_forward`` on
  yolov2 at 64x64 with random BN statistics and biases, at 1e-5;
* ``truncate_spec``'s route shift behind the two-pair stems, and the
  bf16 ``LatencyEngine`` with its fused stem against the JAX engine (the
  JAX stem in interpret mode);
* training refuses route, reorg and shortcut (ROADMAP queue 1, item 16).

The Detector, the CLI, the server and the mAP gates on yolov2 are held
in tests/test_torch_yolov2_apps.py, the int8 program and the engines in
tests/test_torch_yolov2_serving.py.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
import sr_object_detection_tpu.kernels.b1_stem as JBS
import sr_object_detection_tpu.ops.layout as JL
from sr_object_detection_tpu.graph.compiler import build_forward
from sr_object_detection_tpu.infer.engine import LatencyEngine as JLatency
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu.ops.activations import get_activation as j_act
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.infer.engine import (
    LatencyEngine, analytic_flops, fold_params_for_inference)
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.kernels import b1_stem as BS
from sr_object_detection_tpu_torch.kernels import phase_stem as PS
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.ops import layout as L
from sr_object_detection_tpu_torch.ops.activations import get_activation
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import random_bn

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"


def _golden(name):
    g = np.load(GOLDEN / f"{name}.npz")
    return g, S.build_network_spec(parse_cfg_text(bytes(g["cfg"]).decode()))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def params():
    """yolov2's numpy params (the same at every input size) with random
    BN statistics and biases."""
    return random_bn(j_init_params(JZ.yolov2(width=64, height=64), seed=0),
                     1, head_gain=4.0)


# ------------------------------------------------------------- ops ---


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("s,h,w,c", [
    (2, 4, 6, 4), (2, 6, 4, 8), (2, 2, 2, 12), (2, 26, 26, 64),
    (3, 6, 3, 9), (3, 3, 6, 18)])
def test_reorg_matches_jax(reverse, s, h, w, c):
    """Both directions, NHWC (the int8 program's) and NCHW (the
    Network's) forms: equal to the JAX module's (NHWC) reorg."""
    x = np.random.default_rng(c * h + w).normal(0, 1, (2, h, w, c)).astype(
        np.float32)
    j_fn = JL.reorg_reverse_darknet if reverse else JL.reorg_darknet
    t_fn = L.reorg_reverse_darknet if reverse else L.reorg_darknet
    t_nchw = (L.reorg_reverse_darknet_nchw if reverse
              else L.reorg_darknet_nchw)
    ref = np.asarray(j_fn(jnp.asarray(x), stride=s))
    got = t_fn(torch.from_numpy(x), stride=s)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # NCHW, from a channels-last view (the layout a stem's NHWC output
    # has after the Network's permute)
    got = t_nchw(_nchw(x), stride=s).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_route_matches_jax():
    rng = np.random.default_rng(0)
    parts = [rng.normal(0, 1, (2, 3, 5, c)).astype(np.float32)
             for c in (4, 1, 7)]
    ref = np.asarray(JL.route([jnp.asarray(p) for p in parts]))
    np.testing.assert_array_equal(
        L.route([torch.from_numpy(p) for p in parts]).numpy(), ref)
    got = L.route([_nchw(p) for p in parts], dim=1).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("xs,fs", [
    ((4, 4, 8), (4, 4, 8)),        # equal shapes
    ((4, 4, 8), (8, 8, 8)),        # stride 2: the source downsampled
    ((8, 8, 8), (4, 4, 8)),        # sample 2: strided output positions
    ((4, 4, 8), (4, 4, 5)),        # fewer source channels
    ((4, 4, 5), (8, 8, 8)),        # stride 2 and more source channels
    ((6, 6, 3), (3, 3, 6))])       # sample 2 and more source channels
def test_shortcut_matches_jax(xs, fs, act):
    rng = np.random.default_rng(sum(xs) + sum(fs))
    x = rng.normal(0, 1, (2, *xs)).astype(np.float32)
    f = rng.normal(0, 1, (2, *fs)).astype(np.float32)
    ref = np.asarray(JL.shortcut(jnp.asarray(x), jnp.asarray(f), j_act(act)))
    got = L.shortcut_nchw(_nchw(x), _nchw(f), get_activation(act))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


# --------------------------------------------------------- goldens ---


def test_golden_mini_route_reorg():
    """route -2, reorg 2, route -1,-3 and a shortcut from a 16x16 source
    into 8x8 (stride 2), every layer and the output at 2e-5
    (tests/test_parity.py::test_mini_parity)."""
    g, spec = _golden("mini_route_reorg")
    net = Network(spec, params_to_torch(
        spec, init_params(spec, seed=int(g["seed"])), "cpu"))
    x = torch.from_numpy(np.transpose(g["input_chw"], (1, 2, 0))[None].copy())
    with torch.no_grad():
        out, aux = net(x, keep_all=True)
    for i, l in enumerate(spec.layers):
        got = L.nhwc_to_flat(aux["outputs"][i])[0].numpy()
        np.testing.assert_allclose(got, g[f"layer_{i}"], rtol=2e-5,
                                   atol=2e-5, err_msg=f"layer {i} {l.kind}")
    np.testing.assert_allclose(L.nhwc_to_flat(out)[0].numpy(), g["output"],
                               rtol=2e-5, atol=2e-5)


def test_golden_yolo_coco_416():
    """yolov2 (cfg/yolo.cfg, 80 classes) at full width and 416."""
    g, spec = _golden("yolo_coco_416")
    assert len(spec.layers) == 32
    net = Network(spec, params_to_torch(
        spec, init_params(spec, seed=int(g["seed"])), "cpu"))
    x = torch.from_numpy(np.transpose(g["input_chw"], (1, 2, 0))[None].copy())
    with torch.no_grad():
        out, _ = net(x)
    assert out.shape == (1, g["output"].shape[0])
    np.testing.assert_allclose(out[0].numpy(), g["output"], rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------ Network against JAX ---


def test_network_layers_match_jax(params):
    """Every layer's float32 output of yolov2 at 64x64 (keep_all), with
    random BN statistics and biases, against the JAX forward."""
    spec_j = JZ.yolov2(width=64, height=64)
    spec_t = TZ.yolov2(width=64, height=64)
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    fwd = jax.jit(lambda p, v: build_forward(spec_j)(p, v, keep_all=True))
    _, aux_j = fwd(params, jnp.asarray(x))
    net = Network(spec_t, params_to_torch(spec_t, params, "cpu"))
    assert net.live == {16, 24, 27}
    with torch.no_grad():
        out, aux_t = net(torch.from_numpy(x), keep_all=True)
    assert len(aux_t["outputs"]) == len(spec_t.layers) == 32
    assert out is aux_t["outputs"][31]
    for i, l in enumerate(spec_t.layers):
        got = aux_t["outputs"][i].numpy()
        ref = np.asarray(aux_j["outputs"][i])
        assert got.shape == ref.shape, (i, l.kind)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"layer {i} ({l.kind})")
    # without keep_all only the output leaves the network
    with torch.no_grad():
        out2, aux2 = net(torch.from_numpy(x))
    assert list(aux2["outputs"]) == [31] and torch.equal(out2, out)


def test_truncate_spec_shifts_routes(params):
    """Both two-pair stems take layers 0-3 of yolov2; the tail's routes
    read layers 16 and 27, 24 of the whole net, 12 and 23, 20 of the
    tail, and the tail's output equals the whole net's from layer 4's
    input on."""
    spec = TZ.yolov2(width=64, height=64)
    tp, fspec = fold_params_for_inference(
        spec, params_to_torch(spec, params, "cpu"), torch.float32)
    assert BS.plan_pairs(fspec) == PS.plan_pairs(fspec) == [(0, 1), (2, 3)]
    _, jspec = JQ.fold_params_for_inference(
        JZ.yolov2(width=64, height=64), params, dtype=jnp.float32)
    assert JBS.plan_pairs(jspec) == [(0, 1), (2, 3)]
    tail = BS.truncate_spec(fspec, 4)
    routes = [l.layers for l in tail.layers if isinstance(l, S.RouteSpec)]
    assert routes == [(12,), (23, 20)] == [
        l.layers for l in JBS.truncate_spec(jspec, 4).layers
        if type(l).__name__ == "RouteSpec"]
    assert [l.layers for l in fspec.layers
            if isinstance(l, S.RouteSpec)] == [(16,), (27, 24)]
    assert (tail.net.h, tail.net.w, tail.net.c) == (16, 16, 64)
    whole = Network(fspec, tp)
    part = Network(tail, tp[4:])
    assert part.live == {12, 20, 23}
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        out, aux = whole(x, keep_all=True)
        got, _ = part(aux["outputs"][3])
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def test_analytic_flops_counts_yolov2():
    """route and reorg do no arithmetic: the darknet 'ops' count of
    yolov2-608 is the sum of its convs'."""
    spec = TZ.yolov2()
    convs = [l for l in spec.layers if isinstance(l, S.ConvSpec)]
    assert len(convs) == 23
    assert analytic_flops(spec) == sum(
        2.0 * l.filters * l.size ** 2 * l.c * l.out_h * l.out_w
        for l in convs)


# ---------------------------------------------------- LatencyEngine ---


@pytest.fixture
def interpret_b1():
    JBS._INTERPRET = True
    yield
    JBS._INTERPRET = False


def test_latency_engine_fused_matches_jax(params, interpret_b1):
    """bf16 with the batch-1 stem (pairs 3 -> 32 @64 and 32 -> 64 @32)
    against the JAX engine with its stem in interpret mode: the raw
    forward within 2^-7 (two bf16 ulps below 1: both chains are bf16,
    XLA keeps excess precision on the CPU, tests/test_torch_slice.py),
    the same candidates as the engine without the stem."""
    spec_j = JZ.yolov2(width=64, height=64)
    spec_t = TZ.yolov2(width=64, height=64)
    jf = JLatency(spec_j, params, dtype=jnp.bfloat16, fused_stem=True)
    tf = LatencyEngine(spec_t, params, device="cpu", fused_stem=True)
    assert jf.fused_stem and tf.fused_stem
    assert len(tf._net.spec.layers) == 28       # the tail after 4 layers
    x = np.random.RandomState(1).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    oj, _ = jax.jit(jf._fwd)(jf.params, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        ot, _ = tf.forward(torch.from_numpy(x).to(torch.bfloat16))
    oj = np.asarray(oj, np.float32)
    ot = ot.float().numpy()
    np.testing.assert_allclose(ot, oj, rtol=0, atol=2 ** -7)
    plain = LatencyEngine(spec_t, params, device="cpu")
    frame = np.random.RandomState(3).randint(0, 255, (64, 64, 3), np.uint8)
    bf, pf = tf(frame)
    bp, pp = plain(frame)
    assert bf.shape == (20, 4) and pf.shape == (20, 80)  # 2*2*5 < 64
    # the stem rounds once (fused) or twice (the plain chain)
    np.testing.assert_allclose(np.sort(pf.max(-1).values.numpy()),
                               np.sort(pp.max(-1).values.numpy()), atol=2e-2)


# ------------------------------------------------------- training ---


def test_training_refuses_route_reorg_shortcut():
    """Training through route, reorg and shortcut comes with yolov2
    training (ROADMAP queue 1, item 16): the trainer refuses such a spec
    when it is built, and the Network's training forward before it
    computes anything."""
    g, _ = _golden("map_ab_v2")
    spec = S.build_network_spec(parse_cfg_text(bytes(g["cfg"]).decode()))
    for kw in ({}, {"compute_dtype": torch.bfloat16, "phase_train": True,
                    "fused_stem": True}):
        with pytest.raises(NotImplementedError, match="item 16"):
            Trainer(spec, device="cpu", **kw)
    _, mini = _golden("mini_route_reorg")       # ends in a shortcut
    with pytest.raises(NotImplementedError, match="item 16"):
        Trainer(mini, device="cpu")
    net = Network(spec, params_to_torch(spec, init_params(spec), "cpu"))
    with pytest.raises(NotImplementedError, match="item 16"):
        net(torch.zeros(1, 96, 96, 3), train=True)
