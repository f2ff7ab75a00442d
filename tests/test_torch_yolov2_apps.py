"""The port's yolov2 apps on the CPU: the Detector, ``cli detect`` and
the pipe server on a yolov2 cfg and .weights file, against the JAX
package's, and the accuracy gates on the ``map_ab_v2`` set (a yolov2-style
trunk with route and reorg: tests/test_map_parity.py:118-150 and
tests/test_torch_int8.py::test_int8_map_delta):

* the float32 Detector's mAP within 0.1 of the C oracle's stored mAP,
  which is above 0.2;
* the int8 Detector's within 0.05 of the float32 Detector's;
* the int8 Detector with ``quantize_head`` within 0.1 of the oracle's.
"""

import pathlib
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from sr_object_detection_tpu.apps import cli as JCLI
from sr_object_detection_tpu.infer.detector import Detector as JDetector
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.io.weights import save_weights as j_save_weights
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu.ops.image import load_image_rgb as j_load_image_rgb
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.infer.detector import Detector
from torch_parity import random_bn

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"


@pytest.fixture(scope="module")
def params():
    """yolov2's numpy params (the same at every input size) with random
    BN statistics and biases; the head scaled so that random weights
    give probs spread over [0, 0.65] at 96x96."""
    return random_bn(j_init_params(JZ.yolov2(width=64, height=64), seed=0),
                     1, head_gain=16.0)


def _gap_thresh(probs, n=16):
    """A threshold in the widest gap among the reference's best ``n``
    per-box probs, so that the gated differences cannot move a detection
    across it."""
    best = np.sort(probs.max(-1))[::-1][:n]
    gap = int(np.argmax(best[:-1] - best[1:]))
    assert best[gap] - best[gap + 1] > 0.01
    return float((best[gap] + best[gap + 1]) / 2)


def _yolo_cfg_text(size):
    text = bytes(np.load(GOLDEN / "yolo_coco_416.npz")["cfg"]).decode()
    return (text.replace("width=416", f"width={size}")
            .replace("height=416", f"height={size}"))


@pytest.fixture(scope="module")
def yolo_net(tmp_path_factory, params):
    """cfg/yolo.cfg at 96x96 (a 3x3 grid) and a .weights file with
    decisive random params, written by the JAX package."""
    d = tmp_path_factory.mktemp("yolo96")
    cfg = d / "yolo96.cfg"
    cfg.write_text(_yolo_cfg_text(96))
    spec = JZ.yolov2(width=96, height=96)
    w = d / "yolo96.weights"
    j_save_weights(spec, params, str(w))
    return str(cfg), str(w)


def test_detector_matches_jax(yolo_net):
    cfg, weights = yolo_net
    jd = JDetector(cfg, weights)
    td = Detector(cfg, weights, device="cpu")
    assert len(td.spec.layers) == 32
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (120, 100, 3)).astype(np.float32)
    x = jd.preprocess(img)[None]
    np.testing.assert_array_equal(td.preprocess(img)[None], x)
    jb, jp = (np.asarray(t) for t in jd.predict_batch(jnp.asarray(x)))
    tb, tp = (t.numpy() for t in td.predict_batch(x))
    assert tp.shape == (1, 3 * 3 * 5, 80)
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-5)
    thresh = _gap_thresh(jp[0])
    jdets = jd.detect(img, thresh=thresh)
    tdets = td.detect(img, thresh=thresh)
    assert len(jdets) > 0 and len(tdets) == len(jdets)
    for a, b in zip(tdets, jdets):
        assert a.class_id == b.class_id
        np.testing.assert_allclose(a.prob, b.prob, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a.box, b.box, rtol=1e-4, atol=1e-5)


def test_cli_detect_matches_jax(yolo_net, tmp_path):
    cfg, weights = yolo_net
    img = np.random.default_rng(9).integers(0, 256, (90, 110, 3),
                                            dtype=np.uint8)
    ppm = tmp_path / "frame.ppm"
    ppm.write_bytes(b"P6\n110 90\n255\n" + img.tobytes())
    jd = JDetector(cfg, weights)
    _, probs = jd.predict_batch(jnp.asarray(jd.preprocess(
        j_load_image_rgb(str(ppm)))[None]))
    common = [cfg, weights, str(ppm), "-thresh",
              str(_gap_thresh(np.asarray(probs[0])))]
    jdets = JCLI.cmd_detect(list(common))
    tdets = TCLI.cmd_detect(list(common) + ["-cpu"])
    assert len(jdets) > 0
    assert [d.class_id for d in tdets] == [d.class_id for d in jdets]
    np.testing.assert_allclose([d.prob for d in tdets],
                               [d.prob for d in jdets], rtol=1e-4)


def test_serve_matches_detector(yolo_net):
    """The pipe server on the yolov2 cfg answers two requests with the
    in-process Detector's boxes and probs (the server protocol itself is
    held to the JAX server in tests/test_torch_slice.py)."""
    cfg, weights = yolo_net
    rng = np.random.default_rng(10)
    frames = [rng.uniform(0, 1, (80, 112, 3)).astype(np.float32)
              for _ in range(2)]
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               0.05) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         cfg, weights, "--cpu"], input=req, capture_output=True,
        timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out = res.stdout
    assert struct.unpack("<5i", out[:20]) == (0x53524456, 96, 96, 45, 80)
    per = 4 * 45 * (4 + 80)
    assert len(out) == 20 + 2 * per
    det = Detector(cfg, weights, device="cpu")
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det.predict_batch(det.preprocess(f)[None], thresh=0.05)
        np.testing.assert_array_equal(blob[:45 * 4].reshape(45, 4),
                                      wb[0].numpy())
        np.testing.assert_array_equal(blob[45 * 4:].reshape(45, 80),
                                      wp[0].numpy())
        assert (wp > 0).any()


# ------------------------------------------------------ map_ab_v2 ---


@pytest.fixture(scope="module")
def map_ab_v2(tmp_path_factory):
    """The trained v2 A/B detector (cfg + weights) and its synthetic set,
    regenerated byte for byte (digest-guarded)."""
    from tools.synth_dataset import dataset_digest, make_dataset
    g = np.load(GOLDEN / "map_ab_v2.npz")
    d = tmp_path_factory.mktemp("map_ab_v2")
    list_path, gt = make_dataset(str(d / "data"), int(g["n_images"]),
                                 int(g["seed"]))
    assert dataset_digest(str(d / "data")) == bytes(g["digest"]).decode()
    (d / "net.cfg").write_text(bytes(g["cfg"]).decode())
    (d / "w.weights").write_bytes(bytes(g["weights"]))
    paths = [l.strip() for l in open(list_path) if l.strip()]
    return g, str(d / "net.cfg"), str(d / "w.weights"), paths, gt


def _map(det, g, paths, gt):
    """VOC mAP of a port Detector over the set, the protocol of
    tests/test_map_parity.py (thresh, NMS over every box, the same AP
    math) on the port's own decode, NMS and VOC lines."""
    from tools.synth_dataset import N_CLASSES, gt_corner_boxes
    from sr_object_detection_tpu_torch.eval.voc import mean_ap, \
        voc_det_lines
    from sr_object_detection_tpu_torch.kernels import nms as TN
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    thresh, nms = float(g["thresh"]), float(g["nms"])
    names = [str(c) for c in range(N_CLASSES)]
    per_class = {c: [] for c in range(N_CLASSES)}
    for path in paths:
        img = load_image_rgb(path)
        boxes, probs = det.predict_batch(det.preprocess(img)[None],
                                         thresh=thresh)
        probs = TN.nms_sort_topk(boxes[0], probs[0], nms, k=boxes.shape[1])
        lines = voc_det_lines(pathlib.Path(path).stem, boxes[0].numpy(),
                              probs.numpy(), names, img.shape[1],
                              img.shape[0])
        for c in range(N_CLASSES):
            for line in lines[names[c]]:
                f = line.split()
                per_class[c].append((f[0], *map(float, f[1:6])))
    return mean_ap(per_class, gt_corner_boxes(gt))[0]


def test_map_ab_v2_gates(map_ab_v2):
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    g, cfg, weights, paths, gt = map_ab_v2
    oracle = float(g["oracle_map"])
    assert oracle > 0.2                       # the gate is not vacuous
    d32 = Detector(cfg, weights, device="cpu")
    calib = np.stack([d32.preprocess(load_image_rgb(p)) for p in paths[:8]])
    d8 = Detector(cfg, weights, device="cpu", int8_calib=calib)
    d8h = Detector(cfg, weights, device="cpu")
    d8h.quantize(calib, quantize_head=True)
    # the route's sources (a reorg of layer 4 and layer 6) carry other
    # scales, so the int8 route requantizes
    s = d8.net.qnet.act_scales
    assert s[9] == max(s[8], s[6]) and s[8] == s[4] and s[6] != s[8]
    m32, m8, m8h = (_map(d, g, paths, gt) for d in (d32, d8, d8h))
    print(f"mAP oracle={oracle:.4f} f32={m32:.4f} int8={m8:.4f} "
          f"int8+qhead={m8h:.4f}")
    assert abs(m32 - oracle) <= 0.1, (m32, oracle)
    assert abs(m8 - m32) <= 0.05, (m8, m32)
    assert abs(m8h - oracle) <= 0.1, (m8h, oracle)
