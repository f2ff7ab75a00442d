"""ThroughputEngine(phase_stem=True): the bf16 serving stem through the
training pair's fwdstats + apply kernels with identity BN constants
(kernels/phase_train.build_bf16_stem), against the plain bf16 engine
link by link and against the JAX engine with its Pallas stem in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
from sr_object_detection_tpu.infer.engine import ThroughputEngine as JEngine
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.models import zoo as JZ
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from sr_object_detection_tpu_torch.infer.engine import ThroughputEngine
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import assert_bf16_close, random_bn


def test_stem_matches_plain_engine_link_by_link():
    spec = TZ.tiny_yolo_voc(width=64, height=64)
    params = random_bn(init_params(spec, seed=0), 3)
    eng = ThroughputEngine(spec, params, device="cpu", batch=4,
                           phase_stem=True)
    plain = ThroughputEngine(spec, params, device="cpu", batch=4)
    assert eng.phase_stem and not plain.phase_stem
    x = torch.from_numpy(np.random.RandomState(0).rand(
        4, 64, 64, 3).astype(np.float32)).to(torch.bfloat16)
    # the stem pair by pair, each against the plain engine's conv + pool
    # layers on the same input
    layers = plain._net.layers
    v = x
    for ci in (0, 2, 4, 6):
        p = eng.params[ci]
        cout = p["weights"].shape[0]
        zero, one = torch.zeros(cout), torch.ones(cout)
        z, _, _ = TPT.fwdstats(v, p["weights"].permute(2, 3, 1, 0)
                               .contiguous(), zero, one)
        got = TPT.apply(z, zero, one, one, p["biases"].float())
        with torch.no_grad():
            ref = layers[ci + 1](layers[ci](v.permute(0, 3, 1, 2)))
        assert_bf16_close(got.float().numpy(),
                          ref.permute(0, 2, 3, 1).float().numpy())
        v = got
    out = eng(x)
    assert out.shape == plain(x).shape and torch.isfinite(out.float()).all()


def test_stem_engine_matches_jax_stem_engine():
    """32x32, batch 128, at the JAX test's 3e-2
    (tests/test_phase_train.py:285-302)."""
    x = np.random.RandomState(0).rand(128, 32, 32, 3).astype(np.float32)
    jspec = JZ.tiny_yolo_voc(width=32, height=32)
    params = j_init_params(jspec, seed=0)
    JPT._INTERPRET = True
    try:
        je = JEngine(jspec, params, batch=128, phase_stem=True)
        assert je.phase_stem
        want = np.asarray(je(jnp.asarray(x)), np.float32)
    finally:
        JPT._INTERPRET = False
    te = ThroughputEngine(TZ.tiny_yolo_voc(width=32, height=32), params,
                          device="cpu", batch=128, phase_stem=True)
    before = dict(TPT.launches)
    got = te(torch.from_numpy(x)).float().numpy()
    assert TPT.launches == before             # CPU tensors: plain versions
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
