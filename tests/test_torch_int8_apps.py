"""The port's int8 entry points against the JAX package's, on the CPU:
``cli detect -int8 [-qhead]``, ``cli speed`` and ``cli ops``, and
``serve --int8``. The gates and the shared calibration are those of
tests/test_torch_int8.py.
"""

import io
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.apps import cli as JCLI
from sr_object_detection_tpu.graph.spec import parse_network_cfg
from sr_object_detection_tpu.infer import serve as JSERVE
from sr_object_detection_tpu.infer.engine import ThroughputEngine as JThru
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.io.weights import load_weights as j_load_weights
from sr_object_detection_tpu.io.weights import save_weights as j_save_weights
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu.ops.image import resize_image_np
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.infer import serve as TSERVE
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


def test_cli_detect_int8_matches_jax(small_net, tmp_path, monkeypatch):
    """``detect -int8`` calibrates on the image itself, resized; with
    ``-qhead`` the port's CLI gives its own int8-head Detector's dets."""
    cfg, weights = small_net
    img = np.random.default_rng(9).integers(0, 256, (100, 120, 3),
                                            dtype=np.uint8)
    ppm = tmp_path / "frame.ppm"
    ppm.write_bytes(b"P6\n120 100\n255\n" + img.tobytes())
    names = tmp_path / "voc.names"
    names.write_text("\n".join(f"c{i}" for i in range(20)) + "\n")
    calib = resize_image_np(img.astype(np.float32) / 255.0, 128, 128)[None]
    _same_calib(monkeypatch, cfg, weights, calib)
    # a threshold in a gap of the port's probs wider than the gate: the
    # reference's probs then have a gap there too
    td = Detector(cfg, weights, device="cpu", int8_calib=calib)
    _, tp = td.predict_batch(calib)
    thresh = _gap_thresh(tp[0].numpy(), min_gap=0.03 + 2 * PROB_ATOL)
    common = [cfg, weights, str(ppm), "-thresh", str(thresh), "-names",
              str(names), "-int8"]
    jdets = JCLI.cmd_detect(list(common))
    tdets = TCLI.cmd_detect(list(common) + ["-cpu"])
    _same_dets(tdets, jdets)
    qd = Detector(cfg, weights, device="cpu", int8_calib=calib,
                  quantize_head=True, names=[f"c{i}" for i in range(20)])
    got = TCLI.cmd_detect(list(common) + ["-cpu", "-qhead"])
    want = qd.detect(img.astype(np.float32) / 255.0, thresh=thresh)
    assert [(d.class_id, d.prob, d.box) for d in got] == [
        (d.class_id, d.prob, d.box) for d in want]


def test_cli_speed_and_ops_match_jax(tmp_path, capsys, monkeypatch):
    """``ops`` prints the same FLOP count; ``speed`` the same lines, the
    numbers aside (the port's on the CPU here)."""
    cfg = tmp_path / "tiny64.cfg"
    cfg.write_text(_tiny_yolo_cfg_text(64))
    JCLI.cmd_ops([str(cfg)])
    ref = capsys.readouterr().out
    assert TCLI.main(["ops", str(cfg)]) == 0
    assert capsys.readouterr().out == ref
    assert "Floating Point Operations: " in ref

    def shape(text):
        return re.sub(r"\d+\.?\d*", "N", text)
    # the JAX CLI's lines, with its engine's timing replaced (only the
    # format is compared)
    monkeypatch.setattr(JThru, "warmup", lambda self: None)
    monkeypatch.setattr(JThru, "benchmark", lambda self, iters: {
        "images_per_sec": 20.0, "sec_per_batch": 0.1, "batch": 2})
    JCLI.cmd_speed([str(cfg), "1", "-batch", "2"])
    ref = capsys.readouterr().out
    for extra in ([], ["-int8"]):
        TCLI.cmd_speed([str(cfg), "2", "-batch", "2", "-cpu"] + extra)
        got = capsys.readouterr().out
        assert shape(got) == shape(ref) and len(got.splitlines()) == 3


def _serve_in_process(main, argv, frames, thresh, monkeypatch):
    """Run a server's main() in this process on a byte stream; return
    (handshake, [(boxes, probs)])."""
    import struct
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(req)))
    monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out))
    assert main(list(argv)) == 0
    sys.stdout.flush()
    blob = out.getvalue()
    hs = struct.unpack("<5i", blob[:20])
    n_boxes, classes = hs[3], hs[4]
    per = 4 * n_boxes * (4 + classes)
    assert len(blob) == 20 + per * len(frames)
    replies = []
    for i in range(len(frames)):
        r = np.frombuffer(blob[20 + i * per:20 + (i + 1) * per], "<f4")
        replies.append((r[:n_boxes * 4].reshape(n_boxes, 4),
                        r[n_boxes * 4:].reshape(n_boxes, classes)))
    return hs, replies


def test_serve_int8_matches_jax_server(small_net, monkeypatch):
    """``serve --int8`` calibrates on the first frame; both servers run
    in this process, so that both can be fed the same calibration."""
    cfg, weights = small_net
    rng = np.random.default_rng(10)
    frames = [rng.uniform(0, 1, (96, 112, 3)).astype(np.float32)
              for _ in range(2)]
    calib = resize_image_np(frames[0], 128, 128)[None]
    _same_calib(monkeypatch, cfg, weights, calib)
    argv = [cfg, weights, "--cpu", "--int8"]
    hs_j, rep_j = _serve_in_process(JSERVE.main, argv, frames, 0.0,
                                    monkeypatch)
    hs_t, rep_t = _serve_in_process(TSERVE.main, argv, frames, 0.0,
                                    monkeypatch)
    assert hs_t == hs_j == (0x53524456, 128, 128, 4 * 4 * 5, 20)
    for (bt, pt), (bj, pj) in zip(rep_t, rep_j):
        np.testing.assert_allclose(bt, bj, rtol=BOX_RTOL, atol=BOX_ATOL)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_ATOL)
        assert pj.max() > 0.1


