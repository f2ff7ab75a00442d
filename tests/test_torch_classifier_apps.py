"""The port's classifier apps (apps/classifier_app.py) and CLI commands
(classify, classifier, speed) against the JAX package's on the CPU, mode
for mode, on a seeded toy set built as tests/test_misc_train.py builds
it (two classes, brightness by class, the class name in each path). The
weights are written from a seed (training the classifier is the next
slice), so the accuracies are the seeded net's; the two packages must
give the same ones, the same picks and the same probabilities.
"""

import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.apps.classifier_app as JA
import sr_object_detection_tpu.infer.quant as JQ
import sr_object_detection_tpu_torch.apps.classifier_app as TA
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu.apps import cli as JCLI
from sr_object_detection_tpu.graph.spec import parse_network_cfg as j_parse
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.io.weights import save_weights
from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
from sr_object_detection_tpu_torch.ops.image import load_image_rgb
from torch_parity import random_bn

CLS_CFG = """\
[net]
batch=4
subdivisions=1
height={size}
width={size}
channels=3

[convolutional]
filters=8
size=3
stride=2
pad=1
activation=leaky
batch_normalize=1

[avgpool]

[connected]
output={out}
activation=logistic

[cost]
type=masked
"""

# an int8-quantizable trunk (conv, maxpool, the 1x1 logits conv) and the
# float tail darknet19 has (avgpool, softmax, cost)
TAIL_CFG = """\
[net]
batch=1
height=16
width=16
channels=3

[convolutional]
filters=8
size=3
stride=1
pad=1
activation=leaky
batch_normalize=1

[maxpool]
size=2
stride=2

[convolutional]
filters=5
size=1
stride=1
pad=1
activation=linear

[avgpool]

[softmax]
groups=1

[cost]
type=sse
"""

NAMES = ["dark", "lite"]


def _write_ppm(path, img01):
    from tools.synth_dataset import write_ppm
    write_ppm(str(path), (np.clip(img01, 0, 1) * 255).astype(np.uint8))


def _net(tmp, name, text, seed):
    cfg = tmp / f"{name}.cfg"
    cfg.write_text(text)
    spec = parse_network_cfg(str(cfg))
    params = random_bn(j_init_params(j_parse(str(cfg)), seed=seed), seed,
                       head_gain=3.0)
    weights = tmp / f"{name}.weights"
    save_weights(spec, params, str(weights))
    return str(cfg), str(weights)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(data cfg, cfg, weights, image paths): 5 images a class whose
    brightness follows the class, a data cfg naming them as valid and
    test lists (top=2), the toy classifier with seeded weights."""
    tmp = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(7)
    (tmp / "imgs").mkdir()
    paths = []
    for ci, name in enumerate(NAMES):
        level = (ci + 1) / (len(NAMES) + 1)
        for k in range(5):
            img = np.full((16, 16, 3), level, np.float32) + rng.normal(
                0, .05, (16, 16, 3))
            p = tmp / "imgs" / f"{name}_{k}.ppm"
            _write_ppm(p, img)
            paths.append(str(p))
    lst = tmp / "valid.list"
    lst.write_text("\n".join(paths) + "\n")
    labels = tmp / "labels.list"
    labels.write_text("\n".join(NAMES) + "\n")
    data = tmp / "d.data"
    data.write_text(f"valid={lst}\ntest={lst}\nlabels={labels}\n"
                    f"names={labels}\ntop=2\n")
    cfg, weights = _net(tmp, "cls", CLS_CFG.format(size=16, out=2), 11)
    return str(data), cfg, weights, paths


def _numbers(text):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


def _same_text(got, ref):
    """Two outputs line for line: the words equal, the numbers at 1e-5."""
    g, r = got.strip().splitlines(), ref.strip().splitlines()
    assert len(g) == len(r) and g
    for a, b in zip(g, r):
        assert re.sub(r"-?\d+\.\d+", "#", a) == re.sub(r"-?\d+\.\d+", "#", b)
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("mode", ["validate_classifier",
                                  "validate_classifier_multi",
                                  "validate_classifier_crop",
                                  "validate_classifier_full",
                                  "validate_classifier_10"])
def test_validation_modes_match_jax(toy, mode, capsys):
    """valid, valid_multi, valid_crop, valid_full and valid_10: the same
    top-1 and top-k and the same printed lines."""
    data, cfg, weights, _ = toy
    ref = getattr(JA, mode)(data, cfg, weights, [])
    ref_out = capsys.readouterr().out
    got = getattr(TA, mode)(data, cfg, weights, [], device="cpu")
    assert got == ref
    _same_text(capsys.readouterr().out, ref_out)


def test_test_label_and_streams_match_jax(toy):
    """test's TSV rows, label's picks, demo's top-1 per frame, threat's
    rolling gauge and gun's scan lines."""
    data, cfg, weights, _ = toy
    outs = []
    for mod, kw in ((JA, {}), (TA, {"device": "cpu"})):
        o = [io.StringIO() for _ in range(4)]
        n = mod.test_classifier(data, cfg, weights, [], out=o[0], **kw)
        picked = mod.label_classifier(data, cfg, weights, [], out=o[1], **kw)
        frames = [np.random.default_rng(k).uniform(
            0, 1, (16, 16, 3)).astype(np.float32) for k in range(3)]
        demo = mod.demo_classifier(data, cfg, weights, [], frames=frames,
                                   out=io.StringIO(), **kw)
        hist = mod.threat_classifier(data, cfg, weights, [], frames=frames,
                                     out=o[2], **kw)
        flags = mod.gun_classifier(data, cfg, weights, [], frames=frames,
                                   out=o[3], **kw)
        outs.append((n, picked, demo, hist, flags, [x.getvalue() for x in o]))
    (n, picked, demo, hist, flags, text), ref = outs[1], outs[0]
    assert (n, picked, demo, flags) == ref[:3] + (ref[4],)
    assert n == 10 and set(picked) <= set(NAMES)
    np.testing.assert_allclose(hist, ref[3], rtol=1e-5)
    for a, b in zip(text, ref[5]):
        _same_text(a, b)


def test_gun_flags_and_try_match_jax(tmp_path):
    """gun on a 600-output head (some bad categories inside it), and try
    at 224 (resize_min 256, the off-by-one centre crop, normalization,
    layer 0's BN statistics and activations, top-k)."""
    big_cfg, big_w = _net(tmp_path, "big", CLS_CFG.format(size=16, out=600),
                          12)
    frames = [np.random.default_rng(k).uniform(0, 1, (16, 16, 3)).astype(
        np.float32) for k in range(2)]
    o1, o2 = io.StringIO(), io.StringIO()
    f1 = JA.gun_classifier("", big_cfg, big_w, [], frames=frames, out=o1)
    f2 = TA.gun_classifier("", big_cfg, big_w, [], frames=frames, out=o2,
                           device="cpu")
    assert f1 == f2 and any(f2)
    assert o1.getvalue() == o2.getvalue()
    cfg, weights = _net(tmp_path, "t224", CLS_CFG.format(size=224, out=2),
                        13)
    img = tmp_path / "x.ppm"
    _write_ppm(img, np.random.default_rng(1).uniform(
        0, 1, (300, 260, 3)).astype(np.float32))
    o1, o2 = io.StringIO(), io.StringIO()
    p1 = JA.try_classifier("", cfg, weights, str(img), ["-layer", "0"],
                           out=o1)
    p2 = TA.try_classifier("", cfg, weights, str(img), ["-layer", "0"],
                           out=o2, device="cpu")
    np.testing.assert_allclose(p2, np.asarray(p1), rtol=1e-5, atol=1e-6)
    a, b = o2.getvalue().splitlines(), o1.getvalue().splitlines()
    assert len(a) == len(b) == 8 + 8 * 112 * 112 + 1     # top 1
    np.testing.assert_allclose(_numbers("\n".join(a)),
                               _numbers("\n".join(b)), rtol=1e-4, atol=2e-6)


def test_cli_matches_jax(toy, tmp_path, monkeypatch, capsys):
    """`classifier predict`, `classifier valid`, `classify` and `classify
    -int8` (a darknet19-like trunk and float tail; both packages
    calibrated to the JAX amax) through each package's CLI, the same
    lines; without -cpu they and `classifier train` need CUDA; `speed` on
    the classifier cfg runs with -cpu."""
    data, cfg, weights, paths = toy
    for argv in (["classifier", "predict", data, cfg, weights, paths[0]],
                 ["classifier", "valid", data, cfg, weights],
                 ["classify", cfg, weights, paths[7]]):
        JCLI.main(list(argv))
        ref = capsys.readouterr().out
        assert TCLI.main(argv + ["-cpu"]) == 0
        _same_text(capsys.readouterr().out, ref)
    tcfg, tw = _net(tmp_path, "tail", TAIL_CFG, 14)
    img = load_image_rgb(paths[3])
    from sr_object_detection_tpu.ops.image import letterbox_image_np
    calib = letterbox_image_np(img, 16, 16)[None]
    spec_j = j_parse(tcfg)
    from sr_object_detection_tpu.io.weights import load_weights
    pf, fspec = JQ.fold_params_for_inference(
        spec_j, load_weights(spec_j, tw)[0], dtype=jnp.float32)
    amax = JQ.calibrate_amax(fspec, pf, calib)
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    JCLI.main(["classify", tcfg, tw, paths[3], "-int8"])
    ref = capsys.readouterr().out
    assert TCLI.main(["classify", tcfg, tw, paths[3], "-int8", "-cpu"]) == 0
    got = capsys.readouterr().out
    g, r = _numbers(got), _numbers(ref)
    assert [l.split(":")[0] for l in got.splitlines()] == \
        [l.split(":")[0] for l in ref.splitlines()]
    np.testing.assert_allclose(g, r, rtol=2 ** -6)   # the bf16 logits
    # `classifier train` runs (tests/test_torch_classifier_train_apps.py
    # holds it to the JAX package's); without -cpu the commands run on
    # CUDA, which this machine lacks
    tdata = tmp_path / "t.data"
    tdata.write_text(open(data).read().replace("valid=", "train=", 1)
                     + f"backup={tmp_path / 'backup'}\n")
    if not torch.cuda.is_available():
        for argv in (["classify", cfg, weights, paths[0]],
                     ["classifier", "predict", data, cfg, weights,
                      paths[0]], ["classifier", "train", str(tdata), cfg]):
            with pytest.raises((AssertionError, RuntimeError),
                               match="CUDA"):
                TCLI.main(argv)
    assert TCLI.main(["speed", tcfg, "2", "-batch", "2", "-int8",
                      "-cpu"]) == 0
    assert "images/sec (batch 2)" in capsys.readouterr().out
