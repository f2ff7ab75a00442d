"""The port's int8 stem (kernels/phase_stem.py) against the JAX package's
Pallas phase-split stem, run in interpret mode as tests/test_phase_stem.py
runs it.

On the CPU the wrapper takes its plain version (the int8 chain conv ->
dequant + bias -> leaky -> requant -> maxpool); here that chain, built by
the port's ``build_phase_stem`` from the frame requant on, is held
bit-exact to JAX's ``build_phase_stem`` at batch 128 on synthetic stems
with random int8 weights, dequant scales and biases.
tests/test_torch_cuda.py holds the CUDA kernel to the plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_stem as JPS
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.models import zoo as JZ
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
from sr_object_detection_tpu_torch.graph import spec as TS
from sr_object_detection_tpu_torch.models import zoo as TZ


@pytest.fixture
def interpret():
    JPS._INTERPRET = True
    yield
    JPS._INTERPRET = False


def _synthetic_stem(S, H, Cs, seed):
    """Alternating conv3x3(leaky)/maxpool2x2 layers of spec module ``S``
    with random quantized params (numpy) in infer.quant's contract."""
    rng = np.random.RandomState(seed)
    qparams, s_out, layers = [], {}, []
    h = H
    for i, (cin, cout) in enumerate(zip(Cs[:-1], Cs[1:])):
        qparams.extend([
            {"weights": rng.randint(-127, 128, (3, 3, cin, cout)).astype(
                np.int8),
             "dequant": rng.uniform(1e-4, 2e-3, cout).astype(np.float32),
             "biases": rng.uniform(-0.5, 0.5, cout).astype(np.float32)},
            {}])
        s_out[2 * i] = float(rng.uniform(0.005, 0.02))
        s_out[2 * i + 1] = s_out[2 * i]
        layers.append(S.ConvSpec(
            index=2 * i, h=h, w=h, c=cin, inputs=h * h * cin, out_h=h,
            out_w=h, out_c=cout, outputs=h * h * cout, size=3, stride=1,
            pad=1, filters=cout, activation="leaky"))
        layers.append(S.MaxPoolSpec(
            index=2 * i + 1, h=h, w=h, c=cout, inputs=h * h * cout,
            out_h=h // 2, out_w=h // 2, out_c=cout,
            outputs=h * h * cout // 4, size=2, stride=2, pad=0))
        h //= 2
    return (S.NetworkSpec(net=None, layers=tuple(layers), cfg_path=None),
            qparams, s_out)


@pytest.mark.parametrize("h,chans,dtype,n_layers", [
    (16, [3, 16, 8], np.float32, 4),
    (16, [3, 16, 8], np.uint8, 4),
    (24, [3, 5, 7], np.float32, 4),        # odd channels, partial tiles
])
def test_stem_chain_matches_pallas(interpret, h, chans, dtype, n_layers):
    in_scale = 1.0 / 110.0
    spec_j, qp, s_out = _synthetic_stem(JS, h, chans, seed=h)
    spec_t, _, _ = _synthetic_stem(TS, h, chans, seed=h)
    stem_j, n_j = JPS.build_phase_stem(
        spec_j, [{k: jnp.asarray(v) for k, v in p.items()} for p in qp],
        s_out, in_scale)
    stem_t, n_t = TPS.build_phase_stem(
        spec_t, [{k: torch.from_numpy(v) for k, v in p.items()}
                 for p in qp], s_out, in_scale)
    assert n_j == n_t == n_layers
    rng = np.random.RandomState(h + 1)
    x = (rng.randint(0, 256, (128, h, h, 3)).astype(np.uint8)
         if dtype == np.uint8
         else rng.uniform(0, 1, (128, h, h, 3)).astype(np.float32))
    ref = np.asarray(jax.jit(stem_j)(jnp.asarray(x)))
    before = TPS.launches
    got = stem_t(torch.from_numpy(x))
    assert TPS.launches == before          # CPU tensors take the plain path
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert np.abs(ref).max() > 60          # the codes are non-trivial
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plan_pairs_matches_jax():
    for size, want in ((416, 4), (64, 4), (72, 3), (40, 3)):
        j = JZ.tiny_yolo_voc(width=size, height=size)
        t = TZ.tiny_yolo_voc(width=size, height=size)
        assert TPS.plan_pairs(t) == JPS.plan_pairs(j)
        assert len(TPS.plan_pairs(t)) == want
        assert TPS.plan_pairs(t, max_pairs=2) == JPS.plan_pairs(
            j, max_pairs=2)
    spec, qp, s_out = _synthetic_stem(TS, 16, [3, 16, 8], seed=0)
    qp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in qp]
    # a float head conv (no dequant) ends the fused prefix
    del qp[2]["dequant"]
    stem, n = TPS.build_phase_stem(spec, qp, s_out, 1 / 127)
    assert n == 2
    del qp[0]["dequant"]
    assert TPS.build_phase_stem(spec, qp, s_out, 1 / 127) == (None, 0)


def test_stem_pair_i8_takes_frames_and_codes():
    """The first pair takes raw frames with their requant scale
    ``inv_in``, later pairs int8 codes."""
    w = torch.zeros((3, 3, 3, 8), dtype=torch.int8)
    z = torch.zeros(8)
    out = TPS.stem_pair_i8(torch.zeros((2, 4, 4, 3), dtype=torch.uint8),
                           w, z + 1e-3, z, 10.0, inv_in=0.5)
    assert out.shape == (2, 2, 2, 8) and out.dtype == torch.int8
    out = TPS.stem_pair_i8(torch.ones((2, 4, 4, 3), dtype=torch.int8),
                           w, z + 1e-3, z, 10.0)
    assert out.shape == (2, 2, 2, 8)
