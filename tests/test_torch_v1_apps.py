"""The YOLOv1 apps (apps/misc_apps.py's run_yolo_v1, apps/yolo_v1_app.py)
and the nightmare and super apps in the port, through the CLI's `yolo`,
`coco`, `swag`, `nightmare` and `super` commands with -cpu, against the
JAX package's functions on seeded PPMs, labels and weights:

* `yolo train`: 3 iterations, parameters and velocities within 1e-5 of
  each tensor's largest value of the JAX ``run_yolo_v1``'s;
* `yolo test` / `swag test` det for det (prob 1e-5), the PPM written;
  `yolo valid` the comp4 lines matched (image, class file, prob 1e-5,
  corners 1e-3 px), `coco valid` the json records likewise; `yolo recall`
  its counts equal and mean IoU 1e-5; `yolo demo` the detections of
  every frame;
* exact NMS (k = N) at 3 and at 80 classes bit-equal to the JAX
  ``nms_sort_exact``;
* `nightmare` (1 octave, 2 iterations) and `super` at 1e-4; the first
  dream step's gradient through a max-pool at 1e-5 of its largest value.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.apps import misc_apps as JM
from sr_object_detection_tpu.apps import nightmare_app as JN
from sr_object_detection_tpu.apps import super_app as JSup
from sr_object_detection_tpu.apps import yolo_v1_app as JV
from sr_object_detection_tpu.ops import boxes as JB
from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.apps import yolo_v1_app as TV
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.io.convert import params_to_numpy
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                       save_weights)
from tools.synth_dataset import write_ppm
from torch_parity import random_bn

CLASSES = 20       # VOC's: `yolo valid` writes a comp4 file a VOC class
NAMES = JM.VOC_NAMES

V1_CFG = """
[net]
batch={batch}
subdivisions=1
height=32
width=32
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.001
policy=constant
max_batches=3

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=16
size=3
stride=4
pad=1
activation=leaky

[connected]
output={outputs}
activation=linear

[detection]
classes={classes}
coords=4
rescore=1
side=3
num=2
softmax=1
sqrt=1
jitter=.2
coord_scale=5
noobject_scale=.5
"""

# a conv trunk and a deconv head: the super-resolution net's shape
SUPER_CFG = """
[net]
batch=1
height=16
width=16
channels=3

[convolutional]
filters=6
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[deconvolutional]
filters=3
size=2
stride=2
activation=logistic
"""


@pytest.fixture(scope="module")
def v1(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1")
    rng = np.random.default_rng(40)
    (root / "images").mkdir()
    (root / "labels").mkdir()
    paths = []
    for i in range(4):
        h, w = (int(v) for v in rng.integers(30, 60, 2))
        p = root / "images" / f"pic_{i:03d}.ppm"
        write_ppm(str(p), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        (root / "labels" / f"pic_{i:03d}.txt").write_text(
            f"{i % CLASSES} 0.5 0.5 0.4 0.4\n1 0.2 0.7 0.2 0.3\n")
        paths.append(str(p))
    (root / "train.list").write_text("\n".join(paths) + "\n")
    (root / "v1.data").write_text(
        f"train={root}/train.list\nbackup={root}/backup\n")
    cfg = root / "v1.cfg"
    cfg.write_text(V1_CFG.format(batch=2, outputs=9 * (10 + CLASSES),
                                 classes=CLASSES))
    spec = S.parse_network_cfg(str(cfg))
    weights = root / "v1.weights"
    save_weights(spec, random_bn(init_params(spec, seed=41), 42,
                                 head_gain=4.0), str(weights))
    return root, str(cfg), str(weights), paths


def _match(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.class_id == b.class_id
        assert a.prob == pytest.approx(b.prob, abs=1e-5)
        np.testing.assert_allclose(a.box, b.box, atol=1e-5)


def test_yolo_train_matches_jax(v1):
    root, cfg, weights, _ = v1
    jt = JM.run_yolo_v1(str(root / "v1.data"), cfg, weights, [],
                        classes=20)
    tt = cli.COMMANDS["yolo"](["train", str(root / "v1.data"), cfg, weights,
                               "-cpu"])
    spec = S.parse_network_cfg(cfg)
    assert int(tt.state.seen) == int(jt.state.seen) == 6
    for tree in ("params", "velocity"):
        mine = params_to_numpy(spec, getattr(tt.state, tree))
        want = getattr(jt.state, tree)
        for i, l in enumerate(spec.layers):
            for k, v in want[i].items():
                v = np.asarray(v)
                np.testing.assert_allclose(
                    mine[i][k], v, rtol=0, atol=1e-5 * np.abs(v).max(),
                    err_msg=f"{tree} layer {i} ({l.kind}) {k}")


@pytest.mark.parametrize("command", ["yolo", "swag"])
def test_yolo_test_matches_jax(v1, command, tmp_path):
    _, cfg, weights, paths = v1
    want = JV.test_yolo_v1(cfg, weights, paths[0],
                           ["-thresh", "0.05", "-out",
                            str(tmp_path / "jax.ppm")], names=NAMES)
    got = cli.COMMANDS[command](["test", cfg, weights, paths[0], "-thresh",
                                 "0.05", "-out", str(tmp_path / "port.ppm"),
                                 "-cpu"])
    assert all(d.name == TV.VOC_NAMES[d.class_id] for d in got)
    _match(got, want)
    assert (tmp_path / "port.ppm").read_bytes()[:2] == b"P6"


def _comp4(outdir):
    rows = []
    for f in sorted(pathlib.Path(outdir).glob("comp4_det_test_*.txt")):
        for line in f.read_text().splitlines():
            p = line.split()
            rows.append((p[0], f.name, float(p[1]),
                         np.asarray(p[2:6], np.float64)))
    return sorted(rows, key=lambda r: (r[0], r[1], -r[2]))


def test_yolo_valid_matches_jax(v1, tmp_path):
    root, cfg, weights, _ = v1
    args = ["-list", str(root / "train.list"), "-batch", "3"]
    JV.validate_yolo_v1(cfg, weights, args + ["-out", str(tmp_path / "j")],
                        names=None)
    cli.main(["yolo", "valid", cfg, weights, "-out", str(tmp_path / "t"),
              "-cpu"] + args)
    got, want = _comp4(tmp_path / "t"), _comp4(tmp_path / "j")
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert a[:2] == b[:2]
        assert a[2] == pytest.approx(b[2], abs=1e-5)
        np.testing.assert_allclose(a[3], b[3], atol=1e-3)


def test_coco_valid_matches_jax(v1, tmp_path):
    root, cfg, weights, _ = v1
    args = ["-list", str(root / "train.list")]
    JV.validate_yolo_v1(cfg, weights, args + ["-out", str(tmp_path / "j")],
                        names=[str(i) for i in range(80)], coco=True)
    cli.main(["coco", "valid", cfg, weights, "-out", str(tmp_path / "t"),
              "-cpu"] + args)

    def recs(d):
        r = json.loads((d / "coco_results.json").read_text())
        return sorted(r, key=lambda x: (x["image_id"], x["category_id"],
                                        -x["score"]))
    got, want = recs(tmp_path / "t"), recs(tmp_path / "j")
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert (a["image_id"], a["category_id"]) == \
            (b["image_id"], b["category_id"])
        assert a["score"] == pytest.approx(b["score"], abs=1e-5)
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-3)
    assert {r["category_id"] for r in got} <= set(TV.COCO_IDS[:CLASSES])


def test_yolo_recall_matches_jax(v1, capsys):
    root, cfg, weights, _ = v1
    args = ["-list", str(root / "train.list"), "-thresh", "0.3"]
    want = JV.validate_yolo_v1_recall(cfg, weights, list(args))
    got = cli.COMMANDS["yolo"](["recall", cfg, weights, "-cpu"] + args)
    assert {k: got[k] for k in ("proposals", "correct", "total")} == \
        {k: want[k] for k in ("proposals", "correct", "total")}
    assert got["avg_iou"] == pytest.approx(want["avg_iou"], abs=1e-5)
    assert got["total"] == 8
    assert "RPs/Img" in capsys.readouterr().out


def test_yolo_demo_matches_jax(v1):
    root, cfg, weights, _ = v1
    args = ["-frames", str(root / "images" / "pic_00[01].ppm"), "-thresh",
            "0.05"]
    want = JV.demo_yolo_v1(cfg, weights, list(args), names=NAMES)
    got = cli.COMMANDS["yolo"](["demo", cfg, weights, "-cpu"] + args)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _match(a["detections"], b["detections"])


@pytest.mark.parametrize("classes", [3, 80])
def test_exact_nms_matches_jax(classes):
    """The v1 detector's NMS at k = N = 98 (side 7, 2 boxes) on the CPU
    against the JAX ``nms_sort_exact``, bit for bit; ties in probs and
    equal boxes included."""
    rng = np.random.default_rng(classes)
    n = 98
    boxes = np.concatenate([rng.uniform(0, 1, (n, 2)),
                            rng.uniform(.05, .5, (n, 2))], 1).astype(
                                np.float32)
    boxes[10:14] = boxes[9]
    probs = (rng.uniform(0, 1, (n, classes)) ** 3).astype(np.float32)
    probs[probs < 0.1] = 0
    probs[::5, 0] = probs[0, 0]
    det = TV.V1Detector.__new__(TV.V1Detector)
    det.device = torch.device("cpu")
    got = det.nms(boxes, probs, 0.5)
    want = np.asarray(JB.nms_sort_exact(jnp.asarray(boxes),
                                        jnp.asarray(probs), 0.5))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def super_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("super")
    cfg = root / "super.cfg"
    cfg.write_text(SUPER_CFG)
    rng = np.random.default_rng(50)
    img = root / "frame.ppm"
    write_ppm(str(img), rng.integers(0, 256, (24, 20, 3), dtype=np.uint8))
    spec = S.parse_network_cfg(str(cfg))
    weights = root / "super.weights"
    save_weights(spec, random_bn(init_params(spec, seed=51), 52),
                 str(weights))
    return root, str(cfg), str(weights), str(img)


def _read_ppm(path):
    from sr_object_detection_tpu_torch.ops.image import load_image_u8
    return load_image_u8(str(path))


def test_nightmare_matches_jax(super_files, tmp_path):
    root, cfg, weights, img = super_files
    want = JN.nightmare(cfg, weights, img, 0, iters=2, octaves=1,
                        out_dir=str(tmp_path))
    (tmp_path / "port").mkdir()
    got = cli.COMMANDS["nightmare"]([cfg, weights, img, "0", "-iters", "2",
                                     "-octaves", "1", "-out",
                                     str(tmp_path / "port"), "-cpu"])
    assert got.shape == want.shape == (24, 20, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got - _read_ppm(img) / 255.0).max() > 0.01
    assert (tmp_path / "port" / "frame_nightmare_l0_r0.ppm").exists()


def test_dream_step_through_a_pool_matches_jax(v1):
    """nightmare's ascent through a max-pool, its real use: the first
    dream step's input gradient at the conv after the pool, the port's
    ``make_dream_step`` against the JAX one's."""
    from sr_object_detection_tpu.graph import spec as JS
    from sr_object_detection_tpu_torch.apps.nightmare_app import (
        make_dream_step)
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    from sr_object_detection_tpu_torch.io.weights import load_weights
    root, cfg, weights, paths = v1
    spec, jspec = S.parse_network_cfg(cfg), JS.parse_network_cfg(cfg)
    assert isinstance(spec.layers[1], S.MaxPoolSpec)
    params = load_weights(spec, weights)[0]
    x = np.random.default_rng(43).uniform(0, 1, (1, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(JN.make_dream_step(jspec, 2)(params, jnp.asarray(x)))
    got = make_dream_step(spec, 2)(params_to_torch(spec, params, "cpu"),
                                   torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_super_matches_jax(super_files, tmp_path, capsys):
    root, cfg, weights, img = super_files
    want = JSup.super_resolve(cfg, weights, img)
    out = tmp_path / "up.ppm"
    got = cli.COMMANDS["super"](["test", cfg, weights, img, "-out", str(out),
                                 "-cpu"])
    assert got.shape == want.shape == (48, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert "(40x48)" in capsys.readouterr().out
    assert _read_ppm(out).shape == (48, 40, 3)
    # `super train` (train_super, apps/misc_train.py) runs: two
    # iterations from the weights on crops of the image, the net with an
    # sse [cost] head
    (tmp_path / "super.list").write_text(img + "\n")
    cfg2 = tmp_path / "super2.cfg"
    cfg2.write_text(pathlib.Path(cfg).read_text().replace(
        "[net]\n", "[net]\nmax_batches=2\n", 1) + "\n[cost]\ntype=sse\n")
    losses = cli.COMMANDS["super"](["train", str(cfg2), weights, "-list",
                                    str(tmp_path / "super.list"), "-scale",
                                    "2", "-backup", str(tmp_path / "bk"),
                                    "-cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert (tmp_path / "bk" / "super2.weights").exists()
