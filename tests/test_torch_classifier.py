"""darknet19, the classifier family, through the port's serving entry
points on the CPU, against the JAX package on the same seeded inputs:
``Classifier`` in float32 and int8 (and with a ``[softmax] tree=``), the
int8 program's float tail. darknet19 is cut to 64x64 with 100 classes,
as tests/test_quant.py sizes it; the int8 cases calibrate both packages
to the JAX package's amax (tests/test_torch_engines.py says why). The
engines on a classifier are in tests/test_torch_classifier_engines.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu.graph.spec import parse_network_cfg as j_parse
from sr_object_detection_tpu.infer.classifier import Classifier as JClassifier
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
from sr_object_detection_tpu_torch.infer.classifier import Classifier
from sr_object_detection_tpu_torch.io.weights import save_weights
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import random_bn, zoo_cfg_text

BF16_GATE = 2 ** -7   # ROADMAP queue 3, item 5: two bf16 ulps below 1


def _d19(tmp, size, classes, seed=0, gain=6.0):
    """(cfg path, weights path, port spec, JAX spec, numpy params) of
    darknet19 at size x size with ``classes``: init_params from ``seed``
    with random BN statistics and biases, the 1x1 head scaled by
    ``gain`` so that the probs spread."""
    cfg = tmp / f"d19-{size}.cfg"
    cfg.write_text(zoo_cfg_text(TZ.darknet19, width=size, height=size,
                                classes=classes))
    spec_t, spec_j = parse_network_cfg(str(cfg)), j_parse(str(cfg))
    params = random_bn(j_init_params(spec_j, seed=seed), seed + 1,
                       head_gain=gain)
    weights = tmp / f"d19-{size}.weights"
    save_weights(spec_t, params, str(weights))
    return str(cfg), str(weights), spec_t, spec_j, params


@pytest.fixture(scope="module")
def d19(tmp_path_factory):
    return _d19(tmp_path_factory.mktemp("d19"), 64, 100)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
            for h, w in ((64, 64), (80, 50), (45, 70))]


def assert_tail_close(got, ref):
    """The int8 program's probabilities against the JAX program's: the
    trunks are equal, but the bf16 head conv's logits are rounded to bf16
    in the port, as the JAX source writes them, where XLA on the CPU keeps
    float32 (ROADMAP queue 3, item 5). An ulp of a logit is 2^-8 of it,
    and the softmax turns a logit shift into a relative shift of the
    probabilities: within 2^-6 of each probability."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=1e-6)


def _same_amax(monkeypatch, spec_j, params, calib):
    pf, fspec = JQ.fold_params_for_inference(spec_j, params,
                                             dtype=jnp.float32)
    amax = JQ.calibrate_amax(fspec, pf, calib)
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    return amax


def test_classifier_matches_jax(d19, images):
    """float32: probabilities at 1e-6 and the same top-5, on images that
    letterbox three ways."""
    cfg, weights = d19[:2]
    jc, tc = JClassifier(cfg, weights), Classifier(cfg, weights,
                                                   device="cpu")
    for img in images:
        pj, pt = jc.predict(img), tc.predict(img)
        assert pt.shape == (100,) and pt.dtype == np.float32
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)
        assert [i for i, _, _ in tc.predict_topk(img)] == \
            [i for i, _, _ in jc.predict_topk(img)]
    assert pj.max() > 0.05       # the head's gain spreads the probs


def test_classifier_int8_matches_jax(d19, images, monkeypatch):
    """int8_calib: the int8 trunk and the float tail against the JAX
    Classifier's, both calibrated to the JAX amax: the trunks are equal,
    so the bf16 head leaves assert_tail_close's band; the same top-3."""
    cfg, weights, _, spec_j, params = d19
    tc32 = Classifier(cfg, weights, device="cpu")
    calib = np.stack([tc32.preprocess(img) for img in images])
    _same_amax(monkeypatch, spec_j, params, calib)
    jc = JClassifier(cfg, weights, int8_calib=calib)
    tc = Classifier(cfg, weights, device="cpu", int8_calib=calib)
    for img in images:
        pj, pt = jc.predict(img), tc.predict(img)
        assert_tail_close(pt, pj)
        assert np.abs(pt - tc32.predict(img)).max() < 0.05
        assert [i for i, _, _ in tc.predict_topk(img, 3)] == \
            [i for i, _, _ in jc.predict_topk(img, 3)]


def test_classifier_tree_matches_jax(tmp_path):
    """A [softmax] tree= classifier (the mini_tree_cls golden's cfg): the
    grouped softmax and the hierarchy's path products against the JAX
    Classifier."""
    g = np.load("tests/golden/mini_tree_cls.npz")
    tree = tmp_path / "mini.tree"
    tree.write_text(bytes(g["tree"]).decode())
    cfg = tmp_path / "tree.cfg"
    cfg.write_text(bytes(g["cfg"]).decode().replace("{TREE}", str(tree)))
    jc, tc = JClassifier(str(cfg)), Classifier(str(cfg), device="cpu")
    assert tc.tree is not None
    img = np.random.default_rng(2).uniform(0, 1, (10, 9, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tc.predict(img), jc.predict(img), rtol=1e-5,
                               atol=1e-6)


def test_float_tail_matches_jax(d19, monkeypatch):
    """quantize_for_inference on darknet19: the last trunk conv (the
    1000-class 1x1) in bf16, avgpool + softmax as the float tail; from
    float32 and from u8 frames, against the JAX program
    (assert_tail_close)."""
    _, _, spec_t, spec_j, params = d19
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    x = u8.astype(np.float32) / 255.0
    _same_amax(monkeypatch, spec_j, params, x)
    jq = JQ.quantize_for_inference(spec_j, params, x)
    tq = TQ.quantize_for_inference(spec_t, params, x, device="cpu")
    assert tq.act_scales == jq.act_scales
    split = TQ._supported_prefix(tq.spec.layers)
    assert [l.kind for l in tq.spec.layers[split:]] == ["avgpool",
                                                        "softmax", "cost"]
    assert "dequant" not in tq.qparams[split - 1]      # the bf16 head
    for inp in (x, u8):
        got = tq.forward(torch.from_numpy(inp)).numpy()
        ref = np.asarray(jq.forward(jq.qparams, jnp.asarray(inp)))
        assert got.shape == (3, 100) and got.dtype == np.float32
        assert_tail_close(got, ref)
    assert tq.forward(torch.from_numpy(u8), stop=split).dtype == \
        torch.float32                                   # the head's output
