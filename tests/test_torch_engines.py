"""The port's batch engines against the JAX package's, on the CPU:
``QuantizedThroughputEngine`` (batch 128, with and without the phase
stem), the bf16 ``ThroughputEngine``, the int8 ``LatencyEngine`` and
``best_latency_engine``. Both packages calibrate to the same amax (see
tests/test_torch_quant.py for why), so the int8 trunks are equal bit for
bit and only the bf16 head differs, within the gates stated below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.infer.engine import LatencyEngine as JLatency
from sr_object_detection_tpu.infer.engine import ThroughputEngine as JThru
from sr_object_detection_tpu.io.weights import init_params
import sr_object_detection_tpu_torch.infer.quant as TQ
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
from sr_object_detection_tpu_torch.infer import engine as TE
from sr_object_detection_tpu_torch.models import zoo as TZ
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


# ---------------------------------------------------------- engines ---


def _close_region(got, ref, *, raw_atol, act_atol):
    """Flat region outputs ([row][col][anchor][x, y, w, h, obj, cls...]):
    the raw box fields within ``raw_atol``, the activated ones (logistic
    objectness, softmax classes) within ``act_atol``."""
    got = np.asarray(got, np.float32).reshape(-1, 25)
    ref = np.asarray(ref, np.float32).reshape(-1, 25)
    np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=0,
                               atol=raw_atol)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=0,
                               atol=act_atol)
    assert np.abs(ref[:, :4]).max() > 0.5 and ref[:, 4].std() > 0.05


@pytest.fixture(scope="module")
def jax_qte_out(net):
    """The JAX int8 engine (phase_stem=False: JAX's own tests pin its
    phase stem bit-exact to it) on a batch of 128 u8 frames, calibrated
    to ``net``'s JAX amax."""
    spec_j, _, params, calib, amax = net
    mp = pytest.MonkeyPatch()
    mp.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    try:
        eng = JQ.QuantizedThroughputEngine(spec_j, params, batch=128,
                                           calib_x=calib)
    finally:
        mp.undo()
    x = np.random.RandomState(1).randint(0, 256, (128, NET, NET, 3)
                                         ).astype(np.uint8)
    return x, np.asarray(eng(jnp.asarray(x)))


@pytest.mark.parametrize("phase_stem", [False, True])
def test_quantized_engine_matches_jax(net, same_calib, jax_qte_out,
                                      phase_stem):
    """QuantizedThroughputEngine(batch=128) on u8 frames against the JAX
    engine. The int8 trunk is exact (test_int8_trunk_matches_jax, and
    here the stem and plain engines are equal bit for bit); the head conv
    runs in bf16, where XLA on the CPU keeps the bf16 product int8 * s_x
    in float32 (excess precision, ROADMAP queue 3 item 5) and sums in
    another order. So the logits differ by up to one bf16 step: the raw
    box fields within 2^-7 (one bf16 ulp at magnitudes up to 2), the
    logistic/softmax outputs, whose slopes are at most 1/4 and 1, within
    2^-9."""
    _, spec_t, params, calib, _ = net
    x, ref = jax_qte_out
    eng = TQ.QuantizedThroughputEngine(spec_t, params, batch=128,
                                       calib_x=calib, device="cpu",
                                       phase_stem=phase_stem)
    before = TPS.launches
    got = eng(torch.from_numpy(x))
    assert TPS.launches == before         # CPU tensors take the plain path
    assert got.shape == ref.shape == (128, 2 * 2 * 5 * 25)
    _close_region(got.numpy(), ref, raw_atol=2 ** -7, act_atol=2 ** -9)
    if phase_stem:
        plain = TQ.QuantizedThroughputEngine(spec_t, params, batch=128,
                                             calib_x=calib, device="cpu")
        assert torch.equal(got, plain(torch.from_numpy(x)))
        assert torch.equal(eng.qnet.forward(torch.from_numpy(x), stop=13),
                           plain.qnet.forward(torch.from_numpy(x), stop=13))


def test_throughput_engine_matches_jax(net):
    """The bf16 ThroughputEngine at batch 4. Its output is bf16, so the
    gate sits at the output's resolution, 2^-7 (as for the bf16
    LatencyEngine, tests/test_torch_slice.py): XLA's excess precision on
    the CPU makes single-ulp flips unavoidable."""
    spec_j, spec_t, params, _, _ = net
    ej = JThru(spec_j, params, batch=4, dtype=jnp.bfloat16)
    et = TE.ThroughputEngine(spec_t, params, batch=4, device="cpu")
    assert et.input_shape == ej.input_shape == (4, NET, NET, 3)
    x = np.random.RandomState(3).uniform(0, 1, (4, NET, NET, 3)).astype(
        np.float32)
    ref = np.asarray(ej(jnp.asarray(x)), np.float32)
    got = et(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2 ** -7)
    assert np.abs(ref).max() > 0.5


def test_engine_benchmarks_report_the_contract(net):
    _, spec_t, params, calib, _ = net
    bf = TE.ThroughputEngine(spec_t, params, batch=2, device="cpu")
    bf.warmup()
    i8 = TQ.QuantizedThroughputEngine(spec_t, params, batch=2,
                                      calib_x=calib, device="cpu")
    i8.warmup()
    for r in (bf.benchmark(iters=2, warmup=1),
              i8.benchmark(iters=2, warmup=1, input_dtype=torch.uint8)):
        assert set(r) == {"images_per_sec", "sec_per_batch", "batch"}
        assert r["batch"] == 2 and r["images_per_sec"] > 0
        np.testing.assert_allclose(r["sec_per_batch"],
                                   2 / r["images_per_sec"])


def test_latency_engine_int8_matches_jax(net, same_calib):
    """The int8 LatencyEngine: raw forward at the int8 engine's gates
    (see test_quantized_engine_matches_jax), and the same best candidate
    out of the on-device top-k."""
    spec_j, spec_t, params, calib, _ = net
    ej = JLatency(spec_j, params, int8_calib=calib)
    et = TE.LatencyEngine(spec_t, params, device="cpu", int8_calib=calib)
    assert not et.fused_stem and et.dtype == torch.float32
    x = np.random.RandomState(4).uniform(0, 1, (1, NET, NET, 3)).astype(
        np.float32)
    ref, _ = jax.jit(ej._fwd)(ej.params, jnp.asarray(x))
    got, _ = et.forward(torch.from_numpy(x))
    _close_region(got.numpy(), np.asarray(ref), raw_atol=2 ** -7,
                  act_atol=2 ** -9)
    frame = np.random.RandomState(5).randint(0, 256, (NET, NET, 3),
                                             np.uint8)
    bj, pj = (np.asarray(t) for t in ej(frame))
    bt, pt = (t.numpy() for t in et(frame))
    assert bt.shape == bj.shape and pt.shape == pj.shape
    np.testing.assert_allclose(pt.max(-1), pj.max(-1), rtol=0,
                               atol=2 ** -9)
    np.testing.assert_allclose(bt[0], bj[0], rtol=2 ** -6, atol=1e-3)


def test_best_latency_engine_selection(net, monkeypatch):
    """The candidates and the selection dict; the device timer is
    replaced (it times the card with CUDA events and refuses the CPU)."""
    _, spec_t, params, calib, _ = net
    eng = TE.LatencyEngine(spec_t, params, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA events"):
        eng.device_benchmark(reps=1)
    ms = {"bf16": 2.0, "fused": 1.5, "int8": 1.75}

    def fake(self, reps=200):
        kind = ("int8" if self.dtype == torch.float32
                else "fused" if self.fused_stem else "bf16")
        return {"device_ms_per_frame": ms[kind], "reps": reps}
    monkeypatch.setattr(TE.LatencyEngine, "device_benchmark", fake)
    win = TE.best_latency_engine(spec_t, params, device="cpu",
                                 int8_calib=calib, reps=3)
    assert win.selection == {"bf16_ms": 2.0, "fused_ms": 1.5,
                             "int8_ms": 1.75, "chosen": "fused"}
    assert win.fused_stem


def test_unported_options_raise(net):
    _, spec_t, params, calib, _ = net
    for kw, item in (({"phase_stem": True}, "queue 2, row 4"),
                     ({"fuse_pool": True}, "Not ported"),
                     ({"presplit": True}, "item 5"),
                     ({"align_head": True}, "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            TE.ThroughputEngine(spec_t, params, device="cpu", batch=128,
                                **kw)
    with pytest.raises(NotImplementedError, match="item 5"):
        TQ.QuantizedThroughputEngine(spec_t, params, device="cpu",
                                     calib_x=calib, presplit=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        TQ.QuantizedThroughputEngine(spec_t, params, device="cpu",
                                     calib_x=calib, mesh=object())
    with pytest.raises(ValueError, match="batch=128"):
        TQ.QuantizedThroughputEngine(spec_t, params, device="cpu",
                                     calib_x=calib, batch=4,
                                     phase_stem=True)
    y2 = TZ.yolov2(width=64, height=64)
    with pytest.raises(NotImplementedError, match="item 3"):
        TQ.quantize_for_inference(y2, init_params(y2, seed=0), calib,
                                  device="cpu")


