"""The port's serving engines on a classifier (darknet19, no region
head) on the CPU, against the JAX package's: the batch-128 int8 engine
with its phase stem against the JAX one in interpret mode (one case) and
the port's plain engine, the bf16 ThroughputEngine with and without its
stem, the LatencyEngine with and without the fused stem, and the
LatencyEngine's repair (a region-free net returns its output, as the JAX
engine's does). The bf16 gate is ROADMAP queue 3, item 5's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
import sr_object_detection_tpu.kernels.b1_stem as JBS
import sr_object_detection_tpu.kernels.phase_stem as JPS
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu.infer.engine import LatencyEngine as JLatency
from sr_object_detection_tpu.infer.engine import ThroughputEngine as JThru
from sr_object_detection_tpu_torch.infer.engine import (LatencyEngine,
                                                        ThroughputEngine)
from test_torch_classifier import (BF16_GATE, _d19, _same_amax,
                                   assert_tail_close)


@pytest.fixture(scope="module")
def d19(tmp_path_factory):
    return _d19(tmp_path_factory.mktemp("d19"), 64, 100)


@pytest.fixture
def interpret():
    JBS._INTERPRET = True
    JPS._INTERPRET = True
    yield
    JBS._INTERPRET = False
    JPS._INTERPRET = False


def test_stem_engines_at_batch_128(tmp_path, monkeypatch, interpret):
    """darknet19 at 32x32, B=128, u8 frames: the int8 engine with the
    phase stem against the JAX one with its Pallas stem in interpret mode
    (one case; equal trunks, assert_tail_close), and against
    the port's plain engine bit for bit; the bf16 engine with its stem
    within the bf16 gate of the plain one."""
    _, _, spec_t, spec_j, params = _d19(tmp_path, 32, 10, seed=5, gain=3.0)
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (128, 32, 32, 3), dtype=np.uint8)
    calib = u8[:4].astype(np.float32) / 255.0
    _same_amax(monkeypatch, spec_j, params, calib)
    jq = JQ.QuantizedThroughputEngine(spec_j, params, batch=128,
                                      calib_x=calib, phase_stem=True)
    q_stem = TQ.QuantizedThroughputEngine(spec_t, params, batch=128,
                                          calib_x=calib, phase_stem=True,
                                          device="cpu")
    q_plain = TQ.QuantizedThroughputEngine(spec_t, params, batch=128,
                                           calib_x=calib, device="cpu")
    split = TQ._supported_prefix(q_stem.qnet.spec.layers)
    x = torch.from_numpy(u8)
    assert torch.equal(q_stem.qnet.forward(x, stop=split),
                       q_plain.qnet.forward(x, stop=split))
    got = q_stem(x)
    assert torch.equal(got, q_plain(x))
    assert_tail_close(got.numpy(), np.asarray(jq(jnp.asarray(u8))))
    bf = ThroughputEngine(spec_t, params, batch=128, device="cpu")
    bf_stem = ThroughputEngine(spec_t, params, batch=128, device="cpu",
                               phase_stem=True)
    assert bf_stem.phase_stem and not bf.phase_stem
    xf = torch.from_numpy(u8).float() / 255.0
    a, b = bf(xf), bf_stem(xf)
    assert a.shape == b.shape == (128, 10) and a.dtype == torch.bfloat16
    np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                               rtol=0, atol=BF16_GATE)


def test_bf16_engines_match_jax(d19, interpret):
    """bf16 at 64x64: ThroughputEngine against the JAX ThroughputEngine on
    a batch, LatencyEngine with and without the fused stem against the
    JAX LatencyEngines on u8 frames; every prob within the bf16 gate."""
    _, _, spec_t, spec_j, params = d19
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    got = ThroughputEngine(spec_t, params, batch=2, device="cpu")(x)
    ref = JThru(spec_j, params, batch=2)(jnp.asarray(x, jnp.bfloat16))
    assert got.shape == (2, 100) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=BF16_GATE)
    frame = np.random.default_rng(8).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    for fused in (False, True):
        tl = LatencyEngine(spec_t, params, device="cpu", fused_stem=fused)
        jl = JLatency(spec_j, params, dtype=jnp.bfloat16, fused_stem=fused)
        assert tl.fused_stem == jl.fused_stem == fused
        (ot, nt), (oj, nj) = tl(frame), jl(frame)
        assert nt is None and nj is None
        np.testing.assert_allclose(ot.float().numpy(),
                                   np.asarray(oj, np.float32), rtol=0,
                                   atol=BF16_GATE)


def test_latency_engine_returns_region_free_output(d19):
    """The repair: a net without a [region] head (darknet19 ends in
    avgpool, softmax, cost) serves through LatencyEngine, returning
    (output, None) as the JAX engine does (it used to raise ValueError),
    in bf16 and in int8."""
    _, _, spec_t, spec_j, params = d19
    frame = np.random.default_rng(9).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    eng = LatencyEngine(spec_t, params, device="cpu")
    assert eng.region is None
    out, rest = eng(frame)
    assert rest is None and out.shape == (1, 100)
    np.testing.assert_allclose(out.float().sum().item(), 1.0, atol=2e-2)
    calib = (frame[None] / 255.0).astype(np.float32)
    out8, rest8 = LatencyEngine(spec_t, params, device="cpu",
                                int8_calib=calib)(frame)
    assert rest8 is None and out8.dtype == torch.float32
    assert (out8 - out.float()).abs().max().item() < 0.05
