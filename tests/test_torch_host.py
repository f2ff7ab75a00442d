"""The port's JAX-free host modules against their JAX-package originals.

``sr_object_detection_tpu_torch`` carries its own copies of config.py,
graph/spec.py, io/weights.py, models/zoo.py and eval/voc.py, because the
JAX package's ``__init__`` imports jax and the GPU machine has none. These tests hold
each copy equal to its original: the source text, the specs it builds,
the params it draws and the bytes it writes. ``io/convert.py`` (numpy
params -> torch tensors) is checked here too.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import sr_object_detection_tpu.graph.spec as JS
import sr_object_detection_tpu.io.weights as JW
import sr_object_detection_tpu.models.zoo as JZ
import sr_object_detection_tpu.config as JC
import sr_object_detection_tpu_torch.graph.spec as TS
import sr_object_detection_tpu_torch.io.weights as TW
import sr_object_detection_tpu_torch.models.zoo as TZ
import sr_object_detection_tpu_torch.config as TC
from sr_object_detection_tpu_torch.io.convert import params_to_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
COPIES = ["config.py", "graph/spec.py", "io/weights.py", "models/zoo.py",
          "eval/voc.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    orig = (REPO / "sr_object_detection_tpu" / rel).read_bytes()
    copy = (REPO / "sr_object_detection_tpu_torch" / rel).read_bytes()
    assert copy == orig, f"{rel} drifted from the JAX package's original"


def _spec_fields(spec):
    layers = [(type(l).__name__, dataclasses.asdict(l)) for l in spec.layers]
    return dataclasses.asdict(spec.net), layers, spec.cfg_path


def _zoo_pair(name):
    if name == "tiny_yolo_voc":
        return JZ.tiny_yolo_voc(), TZ.tiny_yolo_voc()
    if name == "tiny_yolo_voc_128":
        return (JZ.tiny_yolo_voc(width=128, height=128),
                TZ.tiny_yolo_voc(width=128, height=128))
    if name == "yolov2":
        return JZ.yolov2(), TZ.yolov2()
    return JZ.yolo9000(), TZ.yolo9000()


@pytest.mark.parametrize("name", ["tiny_yolo_voc", "tiny_yolo_voc_128",
                                  "yolov2", "yolo9000"])
def test_zoo_specs_equal(name):
    j, t = _zoo_pair(name)
    assert _spec_fields(t) == _spec_fields(j)


@pytest.mark.parametrize("golden", ["tiny_yolo_voc", "detect_tiny_yolo",
                                    "yolo_coco_416", "mini_conv",
                                    "mini_region"])
def test_golden_cfg_specs_equal(golden):
    text = bytes(np.load(GOLDEN / f"{golden}.npz")["cfg"]).decode()
    j = JS.build_network_spec(JC.parse_cfg_text(text))
    t = TS.build_network_spec(TC.parse_cfg_text(text))
    assert _spec_fields(t) == _spec_fields(j)
    # resize re-runs inference from the stashed raw sections
    assert _spec_fields(t.resize(96, 64)) == _spec_fields(j.resize(96, 64))


def test_init_params_equal():
    j = JW.init_params(JZ.tiny_yolo_voc(), seed=3)
    t = TW.init_params(TZ.tiny_yolo_voc(), seed=3)
    assert len(j) == len(t)
    for pj, pt in zip(j, t):
        assert pj.keys() == pt.keys()
        for k in pj:
            assert pj[k].dtype == pt[k].dtype
            np.testing.assert_array_equal(pt[k], pj[k])


def test_save_weights_byte_identical_and_roundtrip(tmp_path):
    spec_j = JZ.tiny_yolo_voc(width=128, height=128)
    spec_t = TZ.tiny_yolo_voc(width=128, height=128)
    params = JW.init_params(spec_j, seed=1)
    rng = np.random.default_rng(0)
    for p in params:
        for k in ("biases", "scales", "rolling_mean"):
            if k in p:
                p[k] = rng.normal(0, 0.5, p[k].shape).astype(np.float32)
    JW.save_weights(spec_j, params, str(tmp_path / "j.weights"), seen=77)
    TW.save_weights(spec_t, params, str(tmp_path / "t.weights"), seen=77)
    assert ((tmp_path / "t.weights").read_bytes()
            == (tmp_path / "j.weights").read_bytes())
    back, seen = TW.load_weights(spec_t, str(tmp_path / "j.weights"))
    ref, seen_j = JW.load_weights(spec_j, str(tmp_path / "j.weights"))
    assert seen == seen_j == 77
    for pj, pt in zip(ref, back):
        for k in pj:
            np.testing.assert_array_equal(pt[k], pj[k])


def test_params_to_torch_layout_and_dtype():
    spec = TZ.tiny_yolo_voc(width=64, height=64)
    params = TW.init_params(spec, seed=0)
    assert params[0]["weights"].dtype == np.float64   # the narrowing case
    tp = params_to_torch(spec, params, "cpu")
    for l, p, q in zip(spec.layers, params, tp):
        assert p.keys() == q.keys()
        for k in p:
            assert q[k].dtype == torch.float32
            want = np.asarray(p[k], np.float32)
            if k == "weights":
                want = np.transpose(want, (3, 2, 0, 1))   # HWIO -> OIHW
            np.testing.assert_array_equal(q[k].numpy(), want)
    bf = params_to_torch(spec, params, "cpu", torch.bfloat16)
    assert bf[0]["weights"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf[0]["weights"].float().numpy(),
        tp[0]["weights"].to(torch.bfloat16).float().numpy())
