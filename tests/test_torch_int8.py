"""The port's int8 Detector against the JAX package's, on the CPU
(``Detector(int8_calib=)`` and ``Detector.quantize``), and the int8
accuracy gate on the ``map_ab`` set. tests/test_torch_int8_apps.py holds
``cli detect -int8``, ``cli speed``/``ops`` and ``serve --int8`` to the
JAX package.

Both packages are fed JAX's ``calibrate_amax`` result (see
tests/test_torch_quant.py: the two float32 calibration forwards differ
in the last bits, and scales that differ move codes). The int8 trunk is
then exact and the bf16 head conv differs by up to one bf16 step
(tests/test_torch_engines.py), so the decoded outputs are gated at:
boxes 2^-6 relative (w, h = exp(raw) * anchor; x, y through a logistic
of slope <= 1/4), probs 2^-8 absolute (objectness times class, each
within 2^-9).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.graph.spec import parse_network_cfg
from sr_object_detection_tpu.infer.detector import Detector as JDetector
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.io.weights import load_weights as j_load_weights
from sr_object_detection_tpu.io.weights import save_weights as j_save_weights
from sr_object_detection_tpu.models import zoo as JZ
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu_torch.infer.detector import Detector
from torch_parity import random_bn

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
BOX_RTOL, BOX_ATOL, PROB_ATOL = 2 ** -6, 2 ** -9, 2 ** -8


def _tiny_yolo_cfg_text(size):
    text = bytes(np.load(GOLDEN / "tiny_yolo_voc.npz")["cfg"]).decode()
    return (text.replace("width=416", f"width={size}")
            .replace("height=416", f"height={size}"))


@pytest.fixture(scope="module")
def small_net(tmp_path_factory):
    """A 128x128 tiny-yolo-voc cfg + weights file with decisive random
    params, written by the JAX package (the port reads it)."""
    d = tmp_path_factory.mktemp("net128")
    spec = JZ.tiny_yolo_voc(width=128, height=128)
    params = random_bn(j_init_params(spec, seed=0), 1, head_gain=8.0)
    cfg_path = d / "tiny128.cfg"
    cfg_path.write_text(_tiny_yolo_cfg_text(128))
    w_path = d / "tiny128.weights"
    j_save_weights(spec, params, str(w_path))
    return str(cfg_path), str(w_path)


def _same_calib(monkeypatch, cfg, weights, calib):
    """Patch both packages' calibrate_amax to JAX's result for ``calib``
    on the network in ``cfg``/``weights``."""
    spec = parse_network_cfg(cfg)
    params, _ = j_load_weights(spec, weights)
    pf, fspec = JQ.fold_params_for_inference(spec, params,
                                             dtype=jnp.float32)
    amax = JQ.calibrate_amax(fspec, pf, np.asarray(calib, np.float32))
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)


def _gap_thresh(probs, n=16, min_gap=0.03):
    """A threshold in the widest gap among the reference's best ``n``
    per-box probs, so that gated differences cannot move a detection
    across it."""
    best = np.sort(probs.max(-1))[::-1][:n]
    gap = int(np.argmax(best[:-1] - best[1:]))
    assert best[gap] - best[gap + 1] > min_gap
    return float((best[gap] + best[gap + 1]) / 2)


def _same_dets(got, want):
    assert len(want) > 0 and len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.class_id, a.name) == (b.class_id, b.name)
        np.testing.assert_allclose(a.prob, b.prob, rtol=0, atol=PROB_ATOL)
        np.testing.assert_allclose(a.box, b.box, rtol=BOX_RTOL,
                                   atol=BOX_ATOL)


@pytest.mark.parametrize("quantize_head", [False, True])
def test_detector_int8_matches_jax(small_net, monkeypatch, quantize_head):
    cfg, weights = small_net
    rng = np.random.default_rng(8)
    calib = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    _same_calib(monkeypatch, cfg, weights, calib)
    jd = JDetector(cfg, weights, int8_calib=calib,
                   quantize_head=quantize_head)
    if quantize_head:     # in place, on a float Detector
        td = Detector(cfg, weights, device="cpu")
        td.quantize(calib, quantize_head=True)
    else:
        td = Detector(cfg, weights, device="cpu", int8_calib=calib)
    img = rng.uniform(0, 1, (150, 170, 3)).astype(np.float32)
    x = jd.preprocess(img)[None]
    jb, jp = (np.asarray(t) for t in jd.predict_batch(jnp.asarray(x)))
    tb, tp = (t.numpy() for t in td.predict_batch(x))
    # an int8 head leaves only the region activation to differ
    box_rtol, prob_atol = ((1e-5, 1e-6) if quantize_head
                           else (BOX_RTOL, PROB_ATOL))
    np.testing.assert_allclose(tb, jb, rtol=box_rtol, atol=BOX_ATOL)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=prob_atol)
    if not quantize_head:
        thresh = _gap_thresh(jp[0])
        _same_dets(td.detect(img, thresh=thresh),
                   jd.detect(img, thresh=thresh))


def test_int8_map_delta(tmp_path):
    """Accuracy gate of the int8 serving mode (the JAX package's
    tests/test_quant.py::test_int8_map_delta, on the port): on the
    synthetic VOC A/B set, the port's int8 Detector's mAP stays within
    0.05 of the port's float32 mAP."""
    g = np.load(GOLDEN / "map_ab.npz")
    from tools.synth_dataset import (make_dataset, gt_corner_boxes,
                                     N_CLASSES)
    from sr_object_detection_tpu_torch.eval.voc import mean_ap, \
        voc_det_lines
    from sr_object_detection_tpu_torch.kernels import nms as TN
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb

    list_path, gt = make_dataset(str(tmp_path / "data"),
                                 int(g["n_images"]), int(g["seed"]))
    cfg_file = tmp_path / "net.cfg"
    cfg_file.write_text(bytes(g["cfg"]).decode())
    wfile = tmp_path / "w.weights"
    wfile.write_bytes(bytes(g["weights"]))
    paths = [l.strip() for l in open(list_path) if l.strip()]
    det_f32 = Detector(str(cfg_file), str(wfile), device="cpu")
    calib = np.stack([det_f32.preprocess(load_image_rgb(p))
                      for p in paths[:8]])
    det_i8 = Detector(str(cfg_file), str(wfile), device="cpu",
                      int8_calib=calib)
    thresh, nms = float(g["thresh"]), float(g["nms"])
    names = [str(c) for c in range(N_CLASSES)]

    def run_map(det):
        per_class = {c: [] for c in range(N_CLASSES)}
        for path in paths:
            img = load_image_rgb(path)
            ih, iw = img.shape[:2]
            boxes, probs = det.predict_batch(det.preprocess(img)[None],
                                             thresh=thresh)
            probs = TN.nms_sort_topk(boxes[0], probs[0], nms,
                                     k=boxes.shape[1])
            lines = voc_det_lines(pathlib.Path(path).stem,
                                  boxes[0].numpy(), probs.numpy(), names,
                                  iw, ih)
            for c in range(N_CLASSES):
                for line in lines[names[c]]:
                    f = line.split()
                    per_class[c].append((f[0], *map(float, f[1:6])))
        m, _ = mean_ap(per_class, gt_corner_boxes(gt))
        return m

    map_f32, map_i8 = run_map(det_f32), run_map(det_i8)
    print(f"mAP f32={map_f32:.4f} int8={map_i8:.4f}")
    assert map_f32 > 0.2          # not vacuous
    assert abs(map_i8 - map_f32) <= 0.05, (
        f"int8 mAP drifted: {map_i8:.4f} vs f32 {map_f32:.4f}")
