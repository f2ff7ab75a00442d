"""The port's detector apps against the JAX package's, on the CPU:

* exact NMS (``nms_sort_exact``, ``nms_sort``, ``iou_matrix``) bit for
  bit, class-chunked at thousands of classes;
* ``detector valid`` (float32 and ``-int8``), ``detector recall``,
  ``detector test`` and ``detect -out`` through both CLIs;
* ``StreamingDemo`` with a fake detector and with the real one;
* the weight-surgery and inspection commands: every ``.weights`` file
  byte-equal to the JAX CLI's, and ``denormalize`` / ``reset`` keeping
  the port's forward.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.apps import cli as JCLI
from sr_object_detection_tpu.apps.demo_app import StreamingDemo as JDemo
from sr_object_detection_tpu.graph.spec import parse_network_cfg
from sr_object_detection_tpu.infer.detector import Detection as JDetection
from sr_object_detection_tpu.infer.detector import Detector as JDetector
from sr_object_detection_tpu.io.weights import load_weights as j_load_weights
from sr_object_detection_tpu.ops import boxes as JB
from sr_object_detection_tpu.robot.frame_source import (
    ImageDirectorySource as JImageDirectorySource)
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.apps.demo_app import StreamingDemo
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.graph.spec import (
    parse_network_cfg as t_parse_network_cfg)
from sr_object_detection_tpu_torch.infer.detector import Detector
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import load_weights
from sr_object_detection_tpu_torch.kernels import nms as TN
from sr_object_detection_tpu_torch.models.zoo import CfgBuilder
from sr_object_detection_tpu_torch.ops import boxes as TB
from sr_object_detection_tpu_torch.robot.frame_source import (
    ImageDirectorySource, SyntheticRGBDSource)
from tools.synth_dataset import make_dataset

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
# a comp4 line prints prob and corners with %f: the prob equal to the
# printed digit; a pixel corner (x * width in float32, whose own spacing
# is 7.6e-6 at 100 px) within 1e-5 of its magnitude, the port's float32
# box parity with JAX
PROB_ATOL, CORNER_RTOL = 2e-6, 1e-5


# ------------------------------------------------------------ exact NMS

def _nms_inputs(n, c, seed, density=0.3):
    """Seeded boxes with duplicates and probs with ties: equal probs in
    a class, equal probs on equal boxes, empty classes."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(.05, .5, n), rng.uniform(.05, .5, n)],
                     axis=1).astype(np.float32)
    boxes[n // 2:n // 2 + 4] = boxes[n // 2 - 1]
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32)
    probs[probs > density] = 0
    probs[::5, 0] = 0.25
    probs[n // 2 - 1:n // 2 + 4, min(1, c - 1)] = 0.5
    probs[:, c // 2] = 0
    return boxes, probs


@pytest.mark.parametrize("n,c,thresh", [(48, 20, 0.45), (97, 80, 0.3),
                                        (40, 5, 0.0)])
def test_nms_sort_exact_matches_jax(n, c, thresh):
    boxes, probs = _nms_inputs(n, c, seed=n)
    want = np.asarray(JB.nms_sort_exact(jnp.asarray(boxes),
                                        jnp.asarray(probs), thresh))
    tb, tp = torch.from_numpy(boxes), torch.from_numpy(probs)
    for got in (TB.nms_sort_exact(tb, tp, thresh),
                TN.nms_sort_topk(tb, tp, thresh, k=n),
                TB.nms_sort(tb, tp, thresh)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    np.testing.assert_array_equal(
        TB.nms_sort(tb, tp, thresh).numpy(),
        np.asarray(JB.nms_sort(jnp.asarray(boxes), jnp.asarray(probs),
                               thresh)))
    np.testing.assert_array_equal(
        TB.iou_matrix(tb).numpy(),
        np.asarray(JB.iou_matrix(jnp.asarray(boxes))))


def test_nms_sort_exact_chunked_at_thousands_of_classes(monkeypatch):
    """3,000 classes in chunks of 25 (NMS_PLAIN_CHUNK_BYTES lowered) and
    in one chunk, both bit-equal to JAX's per-class lax.map form."""
    n, c = 60, 3000
    boxes, probs = _nms_inputs(n, c, seed=5, density=0.02)
    want = np.asarray(JB.nms_sort_exact(jnp.asarray(boxes),
                                        jnp.asarray(probs), 0.45))
    tb, tp = torch.from_numpy(boxes), torch.from_numpy(probs)
    live = int((tp > 0).any(dim=0).sum())
    assert 1000 < live < c
    top_boxes, top_p, _ = TB.topk_candidates(tb, tp, n)
    whole = TB.nms_per_class_plain(top_boxes, top_p, 0.45)
    np.testing.assert_array_equal(TB.nms_sort_exact(tb, tp, 0.45).numpy(),
                                  want)
    monkeypatch.setattr(TB, "NMS_PLAIN_CHUNK_BYTES", 25 * 4 * n * n)
    np.testing.assert_array_equal(TB.nms_sort_exact(tb, tp, 0.45).numpy(),
                                  want)
    assert torch.equal(TB.nms_per_class_plain(top_boxes, top_p, 0.45), whole)


# ------------------------------------------------------------- the apps

@pytest.fixture(scope="module")
def ab(tmp_path_factory):
    """The map_ab model (cfg + weights) and its seeded PPM frames, a
    .data file listing them and a names file."""
    d = tmp_path_factory.mktemp("map_ab")
    g = np.load(GOLDEN / "map_ab.npz")
    cfg = d / "net.cfg"
    cfg.write_text(bytes(g["cfg"]).decode())
    weights = d / "w.weights"
    weights.write_bytes(bytes(g["weights"]))
    list_path, _ = make_dataset(str(d / "data"), 12, int(g["seed"]))
    (d / "ab.names").write_text("red\ngreen\nblue\n")
    (d / "ab.data").write_text(f"classes = 3\nvalid = {list_path}\n"
                               f"names = {d / 'ab.names'}\n")
    return {"dir": d, "cfg": str(cfg), "weights": str(weights),
            "data": str(d / "ab.data"), "list": list_path,
            "paths": [l.strip() for l in open(list_path) if l.strip()]}


def _comp4(results):
    """{(class file, image id): [(prob, x1, y1, x2, y2), ...]}."""
    out = {}
    for f in sorted(pathlib.Path(results).glob("comp4_det_test_*.txt")):
        for line in f.read_text().splitlines():
            parts = line.split()
            out.setdefault((f.name, parts[0]), []).append(
                tuple(map(float, parts[1:])))
    return out


def _assert_same_comp4(got, want):
    assert got.keys() == want.keys()
    n = 0
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=0,
                                   atol=PROB_ATOL)
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=CORNER_RTOL,
                                   atol=PROB_ATOL)
        n += len(b)
    return n


def test_detector_valid_matches_jax(ab, tmp_path):
    """`detector valid` (thresh .005, exact NMS at k = N): the same
    comp4 lines from both CLIs."""
    argv = ["valid", ab["data"], ab["cfg"], ab["weights"]]
    JCLI.cmd_detector(argv + ["-outdir", str(tmp_path / "jax")])
    TCLI.cmd_detector(argv + ["-outdir", str(tmp_path / "port"), "-cpu"])
    n = _assert_same_comp4(_comp4(tmp_path / "port"),
                           _comp4(tmp_path / "jax"))
    assert n > 100


def test_detector_valid_int8_matches_jax(ab, tmp_path, monkeypatch):
    """`detector valid -int8 -qhead`, calibrated on the first 8 valid
    images by both CLIs (each fed JAX's amax for them, as
    tests/test_torch_int8_apps.py does): the same lines."""
    from sr_object_detection_tpu.ops.image import (load_image_rgb,
                                                   resize_image_np)
    spec = parse_network_cfg(ab["cfg"])
    params, _ = j_load_weights(spec, ab["weights"])
    pf, fspec = JQ.fold_params_for_inference(spec, params,
                                             dtype=jnp.float32)
    calib = np.stack([resize_image_np(load_image_rgb(p), 96, 96)
                      for p in ab["paths"][:8]])
    amax = JQ.calibrate_amax(fspec, pf, calib)
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    argv = ["valid", ab["data"], ab["cfg"], ab["weights"], "-int8",
            "-qhead", "-thresh", "0.05"]
    JCLI.cmd_detector(argv + ["-outdir", str(tmp_path / "jax")])
    TCLI.cmd_detector(argv + ["-outdir", str(tmp_path / "port"), "-cpu"])
    assert _assert_same_comp4(_comp4(tmp_path / "port"),
                              _comp4(tmp_path / "jax")) > 10


def test_detector_recall_matches_jax(ab):
    argv = ["recall", ab["data"], ab["cfg"], ab["weights"], "-thresh",
            "0.1"]
    want = JCLI.cmd_detector(list(argv))
    got = TCLI.cmd_detector(list(argv) + ["-cpu"])
    assert {k: got[k] for k in ("proposals", "total")} == {
        k: want[k] for k in ("proposals", "total")}
    assert got["recall"] == want["recall"] and want["proposals"] > 0
    assert abs(got["avg_iou"] - want["avg_iou"]) <= 1e-6


def _gap_thresh(det, img, n=12):
    """A threshold in the widest gap of a frame's best per-box probs."""
    _, p = det.predict_batch(det.preprocess(img)[None])
    best = np.sort(p[0].numpy().max(-1))[::-1][:n]
    gap = int(np.argmax(best[:-1] - best[1:]))
    assert best[gap] - best[gap + 1] > 1e-3
    return float((best[gap] + best[gap + 1]) / 2)


def test_detect_out_and_detector_test_match_jax(ab, tmp_path):
    """`detect -out` draws the same PPM bytes; `detector test` is
    `detect`."""
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    img_path = ab["paths"][0]
    det = Detector(ab["cfg"], ab["weights"], device="cpu")
    thresh = _gap_thresh(det, load_image_rgb(img_path))
    common = [ab["cfg"], ab["weights"], img_path, "-thresh", str(thresh),
              "-names", str(ab["dir"] / "ab.names")]
    jd = JCLI.cmd_detect(common + ["-out", str(tmp_path / "j.ppm")])
    td = TCLI.cmd_detect(common + ["-out", str(tmp_path / "t.ppm"),
                                   "-cpu"])
    assert len(jd) > 0 and [(d.class_id, d.name) for d in td] == [
        (d.class_id, d.name) for d in jd]
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()
    tt = TCLI.cmd_detector(["test", ab["data"]] + common + ["-cpu"])
    assert [(d.class_id, d.prob, d.box) for d in tt] == [
        (d.class_id, d.prob, d.box) for d in td]


# ------------------------------------------------------------- the demo

class FakeDetector:
    """JAX's tests/test_apps.py TinyDetector: a fixed box and prob."""

    def preprocess(self, img):
        return img[:64, :64]

    def predict_batch(self, x):
        boxes = jnp.tile(jnp.asarray([[0.5, 0.5, 0.2, 0.2]]), (8, 1))
        probs = jnp.zeros((8, 4)).at[0, 1].set(0.9)
        return boxes[None], probs[None]

    def _collect(self, boxes, probs, thresh):
        cls = probs.argmax(1)
        p = probs[np.arange(len(cls)), cls]
        return [JDetection(tuple(boxes[i]), int(cls[i]), float(p[i]))
                for i in np.nonzero(p > thresh)[0]]


def _dets(results):
    return [[(d.class_id, d.prob, d.box) for d in r["detections"]]
            for r in results]


def test_streaming_demo_fake_detector(tmp_path):
    want = JDemo(FakeDetector(), SyntheticRGBDSource(n_frames=4)).run()
    got = StreamingDemo(FakeDetector(), SyntheticRGBDSource(n_frames=4),
                        out_dir=str(tmp_path)).run()
    assert _dets(got) == _dets(want) and all(len(d) == 1 for d in
                                             _dets(got))
    assert len(list(tmp_path.glob("demo_*.ppm"))) == 4


def test_streaming_demo_real_detector(ab):
    """The 3-frame average adds in ring order and divides in float32:
    fed JAX's Detector, the port's demo gives JAX's demo's detections
    bit for bit; with the port's own Detector, within float32 rounding
    of the two forwards."""
    pattern = str(pathlib.Path(ab["list"]).parent / "synth000*.ppm")
    jdet = JDetector(ab["cfg"], ab["weights"])
    want = JDemo(jdet, JImageDirectorySource(pattern), thresh=0.1).run()
    same = StreamingDemo(jdet, ImageDirectorySource(pattern),
                         thresh=0.1).run()
    assert _dets(same) == _dets(want)
    assert sum(map(len, _dets(want))) > 5
    tdet = Detector(ab["cfg"], ab["weights"], device="cpu")
    got = StreamingDemo(tdet, ImageDirectorySource(pattern),
                        thresh=0.1).run()
    assert len(got) == len(want) == 10
    for g, w in zip(_dets(got), _dets(want)):
        assert [c for c, _, _ in g] == [c for c, _, _ in w]
        for (_, pg, bg), (_, pw, bw) in zip(g, w):
            assert abs(pg - pw) <= 1e-6
            np.testing.assert_allclose(bg, bw, rtol=1e-5, atol=1e-6)


def test_detector_demo_cli_frames(ab, tmp_path, capsys):
    pattern = str(pathlib.Path(ab["list"]).parent / "synth000[0-3].ppm")
    res = TCLI.cmd_detector(["demo", ab["data"], ab["cfg"], ab["weights"],
                             "-frames", pattern, "-thresh", "0.1",
                             "-outdir", str(tmp_path), "-cpu"])
    assert len(res) == 4 and len(list(tmp_path.glob("demo_*.ppm"))) == 4
    assert capsys.readouterr().out.count("FPS:") == 4


# ---------------------------------------------------------- surgery

def _surgery_cfg(path):
    """BN convs, a maxpool, a conv without BN and two connected layers
    (one with BN)."""
    b = CfgBuilder()
    b.net(batch=1, width=16, height=16, channels=3)
    b.conv(8, size=3, stride=1)
    b.maxpool()
    b.conv(16, size=3, stride=2)
    b.conv(12, size=1, bn=False, act="linear")
    b.section("connected", output=10, activation="leaky",
              batch_normalize=1)
    b.section("connected", output=4, activation="linear")
    path.write_text(b.text())
    return str(path)


def _random_weights(cfg, path, seed):
    from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                          save_weights)
    from torch_parity import random_bn
    spec = t_parse_network_cfg(cfg)
    save_weights(spec, random_bn(init_params(spec, seed=seed), seed),
                 str(path))
    return str(path)


SURGERY = [("rescale", []), ("reset", []), ("rgbgr", []),
           ("denormalize", []), ("normalize", []), ("partial", ["3"])]


@pytest.mark.parametrize("cmd,extra", SURGERY)
def test_surgery_weights_byte_equal(tmp_path, cmd, extra):
    cfg = _surgery_cfg(tmp_path / "s.cfg")
    w = _random_weights(cfg, tmp_path / "s.weights", 1)
    JCLI.COMMANDS[cmd]([cfg, w, str(tmp_path / "j.weights")] + extra)
    TCLI.COMMANDS[cmd]([cfg, w, str(tmp_path / "t.weights")] + extra)
    assert (tmp_path / "t.weights").read_bytes() == \
        (tmp_path / "j.weights").read_bytes()


def test_average_oneoff_and_inspection_match_jax(tmp_path, capsys):
    cfg = _surgery_cfg(tmp_path / "s.cfg")
    ws = [_random_weights(cfg, tmp_path / f"s{i}.weights", i)
          for i in range(3)]
    for cli, tag in ((JCLI, "j"), (TCLI, "t")):
        cli.COMMANDS["average"]([cfg, str(tmp_path / f"{tag}.avg")] + ws)
    assert (tmp_path / "t.avg").read_bytes() == \
        (tmp_path / "j.avg").read_bytes()
    # oneoff into a wider head: the shape-matching layers move over
    dst = tmp_path / "d.cfg"
    dst.write_text(pathlib.Path(cfg).read_text().replace("output=4",
                                                         "output=6"))
    for cli, tag in ((JCLI, "j"), (TCLI, "t")):
        cli.COMMANDS["oneoff"]([cfg, ws[0], str(dst),
                                str(tmp_path / f"{tag}.one")])
    assert (tmp_path / "t.one").read_bytes() == \
        (tmp_path / "j.one").read_bytes()
    capsys.readouterr()
    for cmd, argv in (("statistics", [cfg, ws[1]]), ("visualize", [cfg])):
        JCLI.COMMANDS[cmd](list(argv))
        want = capsys.readouterr().out
        TCLI.COMMANDS[cmd](list(argv))
        assert capsys.readouterr().out == want and want.count("\n") >= 5


@pytest.mark.parametrize("cmd", ["denormalize", "reset"])
def test_surgery_keeps_the_port_forward(ab, tmp_path, cmd):
    """The folded net computes the same function: the port's forward on
    the map_ab model before and after, within float32 rounding."""
    from torch_parity import random_bn
    spec = t_parse_network_cfg(ab["cfg"])
    params, _ = load_weights(spec, ab["weights"])
    from sr_object_detection_tpu_torch.io.weights import save_weights
    w = tmp_path / "bn.weights"
    save_weights(spec, random_bn(params, 3), str(w))
    out = tmp_path / f"{cmd}.weights"
    TCLI.COMMANDS[cmd]([ab["cfg"], str(w), str(out)])
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, 96, 96, 3)).astype(np.float32))
    ys = []
    for path, folded in ((w, False), (out, True)):
        s = spec
        if folded and cmd == "denormalize":
            from sr_object_detection_tpu_torch.io import surgery
            _, s = surgery.denormalize_net(params, spec)
        p, _ = load_weights(s, str(path))
        ys.append(Network(s, params_to_torch(s, p, "cpu"))(x)[0])
    assert ys[0].abs().max() > 0.1
    torch.testing.assert_close(ys[1], ys[0], rtol=1e-4, atol=1e-4)
