"""The port's ops against the JAX package's, on the same numpy inputs.

Every input is drawn from a seeded numpy generator and handed to both
sides as numpy; comparisons are float32 at 1e-5 unless stated (the two
frameworks sum in different orders). BN scales, means, variances and
biases are drawn non-trivially: ``init_params`` sets biases to zero and
BN to the identity, which would hide bias and BN bugs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.ops import activations as JA
from sr_object_detection_tpu.ops import boxes as JB
from sr_object_detection_tpu.ops import conv as JC
from sr_object_detection_tpu.ops import image as JI
from sr_object_detection_tpu.ops import layout as JL
from sr_object_detection_tpu.ops import pooling as JP
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.ops import activations as TA
from sr_object_detection_tpu_torch.ops import boxes as TB
from sr_object_detection_tpu_torch.ops import conv as TC
from sr_object_detection_tpu_torch.ops import image as TI
from sr_object_detection_tpu_torch.ops import layout as TL
from sr_object_detection_tpu_torch.ops import pooling as TP

TOL = 1e-5


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nchw_to_nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _bn(rng, c):
    return dict(scales=rng.uniform(0.5, 1.5, c).astype(np.float32),
                rolling_mean=rng.normal(0, 0.3, c).astype(np.float32),
                rolling_variance=rng.uniform(0.2, 2.0, c).astype(np.float32),
                biases=rng.normal(0, 0.3, c).astype(np.float32))


@pytest.mark.parametrize("name", sorted(TA.ACTIVATIONS))
def test_activation_matches(name):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-6, 6, 997),
                        [-4.0, 4.0, 0.0, 1.0, -1.0, 2.5, -2.5, 3.0]]
                       ).astype(np.float32)
    got = TA.get_activation(name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(JA.get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_unknown_activation_is_relu():
    assert TA.get_activation("nope") is TA.relu


@pytest.mark.parametrize("size,stride,pad", [(3, 1, 1), (1, 1, 0),
                                             (3, 2, 1), (3, 2, 0)])
def test_conv2d_f32_matches(size, stride, pad):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 11, 13, 5)).astype(np.float32)
    w = rng.normal(0, 0.3, (size, size, 5, 7)).astype(np.float32)
    ref = np.asarray(JC.conv2d(jnp.asarray(x), jnp.asarray(w),
                               stride=stride, pad=pad))
    got = TC.conv2d(_nhwc_to_nchw(x), torch.from_numpy(
        np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))),
        stride=stride, pad=pad)
    np.testing.assert_allclose(_nchw_to_nhwc(got), ref, rtol=TOL, atol=TOL)


def test_batchnorm_eps_outside_sqrt():
    """(x-mean)/(sqrt(var)+1e-6): at var ~ 1e-10 the eps placement
    dominates, and F.batch_norm (eps inside the sqrt) is far off."""
    rng = np.random.default_rng(2)
    c = 6
    x = rng.normal(0, 1e-4, (1, 3, 4, c)).astype(np.float32)
    p = _bn(rng, c)
    var = np.full(c, 1e-10, np.float32)
    ref = np.asarray(JC.batchnorm_inference(
        jnp.asarray(x), p["scales"], p["rolling_mean"], var))
    t = [torch.from_numpy(a) for a in (p["scales"], p["rolling_mean"], var)]
    got = _nchw_to_nhwc(TC.batchnorm_inference(_nhwc_to_nchw(x), *t))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    inside = torch.nn.functional.batch_norm(
        _nhwc_to_nchw(x), t[1], t[2], t[0], None, False, 0.0, 1e-6)
    assert not np.allclose(_nchw_to_nhwc(inside), ref, rtol=0.1)


@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("act", ["leaky", "linear", "logistic"])
def test_conv_block_f32_matches(bn, act):
    rng = np.random.default_rng(3)
    cin, cout = 4, 8
    spec = S.ConvSpec(index=0, filters=cout, size=3, stride=1, pad=1,
                      activation=act, batch_normalize=bn)
    x = rng.normal(0, 1, (1, 9, 10, cin)).astype(np.float32)
    p = _bn(rng, cout)
    if not bn:
        p = {"biases": p["biases"]}
    p["weights"] = rng.normal(0, 0.3, (3, 3, cin, cout)).astype(np.float32)
    ref = np.asarray(JC.conv_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, spec,
        JA.get_activation(act)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["weights"] = tp["weights"].permute(3, 2, 0, 1).contiguous()
    got = TC.conv_block(_nhwc_to_nchw(x), tp, spec, TA.get_activation(act))
    np.testing.assert_allclose(_nchw_to_nhwc(got), ref, rtol=TOL, atol=TOL)


def test_conv_block_bf16_rounds_before_bias():
    """With compute_dtype=bf16 the conv output is rounded to bf16 before
    the bias, then again after the activation — the JAX chain."""
    rng = np.random.default_rng(4)
    cin, cout = 8, 16
    spec = S.ConvSpec(index=0, filters=cout, size=3, stride=1, pad=1,
                      activation="leaky")
    x = rng.normal(0, 1, (1, 12, 12, cin)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.3, cout).astype(np.float32)
    ref = np.asarray(JC.conv_block(
        jnp.asarray(x, jnp.bfloat16),
        {"weights": jnp.asarray(w, jnp.bfloat16),
         "biases": jnp.asarray(b, jnp.bfloat16)},
        spec, JA.leaky, compute_dtype=jnp.bfloat16).astype(jnp.float32))
    got = TC.conv_block(
        _nhwc_to_nchw(x).to(torch.bfloat16),
        {"weights": torch.from_numpy(np.ascontiguousarray(
            np.transpose(w, (3, 2, 0, 1)))).to(torch.bfloat16),
         "biases": torch.from_numpy(b).to(torch.bfloat16)},
        spec, TA.leaky, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = _nchw_to_nhwc(got)
    # a 1-ulp bf16 difference in the rounded conv output is allowed
    # (float32 sums in another order): 2^-7 relative, plus a floor
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-2)
    assert np.mean(got == ref) > 0.95


def test_fold_batchnorm_matches():
    rng = np.random.default_rng(5)
    p = _bn(rng, 8)
    p["weights"] = rng.normal(0, 0.3, (3, 3, 4, 8)).astype(np.float32)
    ref = JC.fold_batchnorm({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["weights"] = tp["weights"].permute(3, 2, 0, 1)
    got = TC.fold_batchnorm(tp)
    np.testing.assert_allclose(got["biases"].numpy(), ref["biases"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["weights"].permute(2, 3, 1, 0).numpy(),
                               ref["weights"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,size,stride,pad", [
    (13, 2, 1, 0),      # tiny-yolo layer 11: the last window overhangs
    (26, 2, 2, 0),      # the tiled 2x2/2 case
    (9, 3, 1, 1),       # symmetric pad
    (11, 3, 2, 1),      # odd input, stride 2
    (7, 2, 2, 0),       # odd input: the last row/col is dropped
])
def test_maxpool_matches(h, size, stride, pad):
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, h, h + 1, 3)).astype(np.float32)
    ref = np.asarray(JP.maxpool(jnp.asarray(x), size=size, stride=stride,
                                pad=pad))
    got = _nchw_to_nhwc(TP.maxpool(_nhwc_to_nchw(x), size=size,
                                   stride=stride, pad=pad))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_layout_flat_roundtrip():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(JL.nhwc_to_flat(jnp.asarray(x)))
    got = TL.nhwc_to_flat(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = TL.flat_to_nhwc(got, 3, 5, 4)
    np.testing.assert_array_equal(back.numpy(), x)


def _boxes(rng, n):
    return np.stack([rng.uniform(0, 10, n), rng.uniform(0, 10, n),
                     rng.uniform(.5, 3, n), rng.uniform(.5, 3, n)],
                    axis=1).astype(np.float32)


def test_box_iou_matches():
    rng = np.random.default_rng(8)
    a, b = _boxes(rng, 50), _boxes(rng, 50)
    ref = np.asarray(JB.box_iou(jnp.asarray(a)[:, None], jnp.asarray(b)[None]))
    got = TB.box_iou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("softmax", [True, False])
def test_region_activate_and_decode_match(softmax):
    rng = np.random.default_rng(9)
    a, classes = 5, 20
    nf = classes + 5
    raw = rng.normal(0, 2, (2, 4, 6, a * nf)).astype(np.float32)
    anchors = rng.uniform(0.5, 4, (a, 2)).astype(np.float32)
    ref = JB.region_activate(jnp.asarray(raw), a, nf, softmax=softmax)
    got = TB.region_activate(torch.from_numpy(raw), a, nf, softmax=softmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=1e-6)
    rb = JB.decode_region_boxes(ref, anchors, img_w=1.0, img_h=1.0)
    gb = TB.decode_region_boxes(got, anchors, img_w=1.0, img_h=1.0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=TOL,
                               atol=1e-6)
    rp = JB.region_class_probs(ref, thresh=0.02)
    gp = TB.region_class_probs(got, thresh=0.02)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=TOL,
                               atol=1e-6)


def test_resize_image_np_and_torch_match():
    rng = np.random.default_rng(10)
    im = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    for w, h in [(16, 16), (60, 41), (1, 5)]:
        ref = JI.resize_image_np(im, w, h)
        np.testing.assert_array_equal(TI.resize_image_np(im, w, h), ref)
        got = TI.resize_image(torch.from_numpy(im), w, h).numpy()
        np.testing.assert_allclose(
            got, np.asarray(JI.resize_image(jnp.asarray(im), w, h)),
            rtol=TOL, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(TI.letterbox_image_np(im, 32, 48),
                                  JI.letterbox_image_np(im, 32, 48))


def test_load_pnm_matches(tmp_path):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    p = tmp_path / "x.ppm"
    p.write_bytes(b"P6\n# comment\n9 7\n255\n" + img.tobytes())
    got = TI._load_pnm(str(p))
    np.testing.assert_array_equal(got, JI._load_pnm(str(p)))
    np.testing.assert_array_equal(TI.load_image_rgb(str(p)), got)
