"""The batch engines' phase stems on yolov2 at 32x32, batch 128 (pairs
3 -> 32 @32 and 32 -> 64 @16; the route -9 reads layer 16, past them), on
the CPU:

* ``ThroughputEngine(phase_stem=True)`` (bf16, kernel 4's mode ``fwd``)
  against the JAX engine with its Pallas stem in interpret mode, at the
  JAX package's gate for its stem engine, 3e-2
  (tests/test_phase_train.py:285-302; tests/test_torch_bf16_stem.py);
* ``QuantizedThroughputEngine(phase_stem=True)`` equal to the engine
  without the stem (the JAX package pins its own stem bit-exact to the
  chain, and tests/test_torch_yolov2_serving.py holds the chain to JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
from sr_object_detection_tpu.infer.engine import ThroughputEngine as JEngine
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.models import zoo as JZ
import sr_object_detection_tpu_torch.infer.quant as TQ
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from sr_object_detection_tpu_torch.infer.engine import ThroughputEngine
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import random_bn

NF = 85            # region fields: x, y, w, h, objectness, 80 classes


@pytest.fixture(scope="module")
def params():
    """yolov2's numpy params (the same at every input size) with random
    BN statistics and biases."""
    return random_bn(j_init_params(JZ.yolov2(width=32, height=32), seed=0),
                     1, head_gain=4.0)


def test_bf16_stem_engine_matches_jax(params):
    x = np.random.RandomState(0).rand(128, 32, 32, 3).astype(np.float32)
    JPT._INTERPRET = True
    try:
        je = JEngine(JZ.yolov2(width=32, height=32), params, batch=128,
                     phase_stem=True)
        assert je.phase_stem
        want = np.asarray(je(jnp.asarray(x)), np.float32)
    finally:
        JPT._INTERPRET = False
    te = ThroughputEngine(TZ.yolov2(width=32, height=32), params,
                          device="cpu", batch=128, phase_stem=True)
    assert te.phase_stem and len(te._net.spec.layers) == 28
    before = dict(TPT.launches)
    got = te(torch.from_numpy(x)).float().numpy()
    assert TPT.launches == before             # CPU tensors: plain versions
    assert got.shape == (128, 5 * NF)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    assert np.abs(want).max() > 0.5


@pytest.fixture(scope="module")
def engines32(params):
    """The int8 batch engine on yolov2 at 32x32, batch 128, with and
    without its phase stem (pairs 3 -> 32 and 32 -> 64), calibrated on
    one batch."""
    spec = TZ.yolov2(width=32, height=32)
    calib = np.random.RandomState(0).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    return [TQ.QuantizedThroughputEngine(spec, params, batch=128,
                                         calib_x=calib, device="cpu",
                                         phase_stem=ps)
            for ps in (True, False)]


def test_int8_engine_phase_stem_equals_plain(engines32):
    """The stem owns layers 0-3; routes read past it. On u8 frames the
    stem engine's trunk and output equal the plain engine's bit for bit
    (its CUDA kernel is bit-exact to the same chain: tests/
    test_torch_cuda.py); on CPU tensors no kernel launches."""
    stem, plain = engines32
    assert TPS.plan_pairs(stem.qnet.spec) == [(0, 1), (2, 3)]
    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (128, 32, 32, 3)).astype(np.uint8))
    before = TPS.launches
    got = stem(x)
    assert TPS.launches == before
    assert got.shape == (128, 5 * NF) and torch.isfinite(got).all()
    assert torch.equal(got, plain(x))
    assert torch.equal(stem.qnet.forward(x, stop=30),
                       plain.qnet.forward(x, stop=30))
    with pytest.raises(ValueError, match="inside the fused stem"):
        stem.qnet.forward(x, stop=3)
