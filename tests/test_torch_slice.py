"""The port's tiny-yolo-voc detection slice end to end, on the CPU.

* the float32 Detector against the C-oracle goldens at the full 416
  (``tiny_yolo_voc.npz`` forward, ``detect_tiny_yolo.npz`` decode + NMS,
  the gates of tests/test_parity.py);
* the float32 Detector and the CLI against the JAX package's, with
  non-trivial BN statistics and biases;
* the bf16 LatencyEngine with the fused stem against the JAX package's;
* the pipe server against the JAX package's server, byte protocol and
  payload;
* the port imports and runs with ``jax`` and the JAX package blocked.
"""

import pathlib
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.b1_stem as JBS
from sr_object_detection_tpu.apps import cli as JCLI
from sr_object_detection_tpu.infer.detector import Detector as JDetector
from sr_object_detection_tpu.infer.engine import LatencyEngine as JLatency
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.io.weights import save_weights as j_save_weights
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.infer.detector import Detector
from sr_object_detection_tpu_torch.infer.engine import LatencyEngine
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import init_params, save_weights
from sr_object_detection_tpu_torch.kernels import nms as TN
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import random_bn

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"


def _golden(name):
    g = np.load(GOLDEN / f"{name}.npz")
    cfg = bytes(g["cfg"]).decode()
    return g, cfg, S.build_network_spec(parse_cfg_text(cfg))


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
    return str(cfg_path), str(w_path), params


def _tiny_yolo_cfg_text(size):
    g = np.load(GOLDEN / "tiny_yolo_voc.npz")
    text = bytes(g["cfg"]).decode()
    return (text.replace("width=416", f"width={size}")
            .replace("height=416", f"height={size}"))


# ------------------------------------------------------------ goldens ---


def test_golden_forward_full_width():
    g, _, spec = _golden("tiny_yolo_voc")
    params = init_params(spec, seed=int(g["seed"]))
    net = Network(spec, params_to_torch(spec, params, "cpu"))
    x = torch.from_numpy(np.transpose(g["input_chw"], (1, 2, 0))[None].copy())
    with torch.no_grad():
        out, _ = net(x)
    assert out.shape == (1, g["output"].shape[0])
    np.testing.assert_allclose(out[0].numpy(), g["output"], rtol=2e-4,
                               atol=2e-4)


def test_golden_detect_full_width(tmp_path):
    """get_region_boxes + do_nms_sort vs the C oracle, the gates of
    test_parity.py::test_detector_decode_nms_parity."""
    g, cfg, spec = _golden("detect_tiny_yolo")
    (tmp_path / "net.cfg").write_text(cfg)
    params = init_params(spec, seed=int(g["seed"]))
    save_weights(spec, params, str(tmp_path / "w.weights"))
    det = Detector(str(tmp_path / "net.cfg"), str(tmp_path / "w.weights"),
                   device="cpu")
    x = np.transpose(g["input_chw"], (1, 2, 0))[None]
    boxes, probs = det.predict_batch(x)
    thresh, nms = float(g["thresh"]), float(g["nms"])
    probs = torch.where(probs[0] > thresh, probs[0], 0.0)
    probs = TN.nms_sort_topk(boxes[0], probs, nms, k=len(boxes[0])).numpy()
    np.testing.assert_allclose(boxes[0].numpy(), g["boxes"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(probs > 0, g["probs"] > 0)
    np.testing.assert_allclose(probs, g["probs"], rtol=3e-4, atol=3e-4)


# ----------------------------------------------- Detector against JAX ---


@pytest.mark.parametrize("letterbox", [False, True])
def test_detector_matches_jax(small_net, letterbox):
    cfg, weights, _ = small_net
    jd = JDetector(cfg, weights, letterbox=letterbox)
    td = Detector(cfg, weights, device="cpu", letterbox=letterbox)
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (150, 170, 3)).astype(np.float32)
    x = jd.preprocess(img)[None]
    np.testing.assert_array_equal(td.preprocess(img)[None], x)
    jb, jp = (np.asarray(t) for t in jd.predict_batch(jnp.asarray(x),
                                                      thresh=0.05))
    tb, tp = (t.numpy() for t in td.predict_batch(x, thresh=0.05))
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-5)
    jdets = jd.detect(img, thresh=0.45)
    tdets = td.detect(img, thresh=0.45)
    assert len(jdets) > 0 and len(tdets) == len(jdets)
    for a, b in zip(tdets, jdets):
        assert a.class_id == b.class_id
        np.testing.assert_allclose(a.prob, b.prob, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a.box, b.box, rtol=1e-4, atol=1e-5)


def test_cli_detect_matches_jax(small_net, tmp_path):
    cfg, weights, _ = small_net
    img = np.random.default_rng(9).integers(0, 256, (100, 120, 3),
                                            dtype=np.uint8)
    ppm = tmp_path / "frame.ppm"
    ppm.write_bytes(b"P6\n120 100\n255\n" + img.tobytes())
    names = tmp_path / "voc.names"
    names.write_text("\n".join(f"c{i}" for i in range(20)) + "\n")
    common = [cfg, weights, str(ppm), "-thresh", "0.45", "-names",
              str(names)]
    jdets = JCLI.cmd_detect(list(common))
    tdets = TCLI.cmd_detect(list(common) + ["-cpu"])
    assert len(jdets) > 0
    assert [(d.name, d.class_id) for d in tdets] == [
        (d.name, d.class_id) for d in jdets]
    np.testing.assert_allclose([d.prob for d in tdets],
                               [d.prob for d in jdets], rtol=1e-4)


def test_network_layers_match_jax():
    """Every layer's float32 output (keep_all) against the JAX forward,
    with random BN statistics and biases."""
    from sr_object_detection_tpu.graph.compiler import build_forward
    spec_j = JZ.tiny_yolo_voc(width=64, height=64)
    spec_t = TZ.tiny_yolo_voc(width=64, height=64)
    params = random_bn(j_init_params(spec_j, seed=4), 5)
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    _, aux_j = build_forward(spec_j)(params, jnp.asarray(x), keep_all=True)
    net = Network(spec_t, params_to_torch(spec_t, params, "cpu"))
    with torch.no_grad():
        out, aux_t = net(torch.from_numpy(x), keep_all=True)
    assert len(aux_t["outputs"]) == len(spec_t.layers)
    assert out is aux_t["outputs"][len(spec_t.layers) - 1]
    for i, l in enumerate(spec_t.layers):
        got = aux_t["outputs"][i].numpy()
        ref = np.asarray(aux_j["outputs"][i])
        assert got.shape == ref.shape, (i, l.kind)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"layer {i} ({l.kind})")


def test_unported_layer_kinds_raise_at_build():
    """route and reorg are built since yolov2 (tests/test_torch_yolov2.py),
    the classifier family's kinds since darknet19 (tests/
    test_torch_layers.py) and a [detection] head since the last kinds'
    slice (tests/test_torch_detection.py); only the JAX optimizer's
    polyphase rewrite, never parsed from a cfg, raises at build."""
    spec = TZ.darknet19(width=64, height=64, classes=10)
    Network(spec, params_to_torch(spec, init_params(spec, seed=0), "cpu"))
    from sr_object_detection_tpu_torch.config import parse_cfg_text
    from sr_object_detection_tpu_torch.graph.spec import build_network_spec
    spec = build_network_spec(parse_cfg_text(
        "[net]\nheight=14\nwidth=14\nchannels=3\n\n[convolutional]\n"
        "filters=10\nsize=3\nstride=2\npad=1\nactivation=leaky\n\n"
        "[detection]\nclasses=5\ncoords=4\nnum=1\nside=7\n"))
    params = params_to_torch(spec, init_params(spec, seed=0), "cpu")
    with torch.no_grad():
        out, _ = Network(spec, params)(torch.rand(1, 14, 14, 3))
    assert out.shape == (1, 7 * 7 * 10)
    from sr_object_detection_tpu_torch.graph.compiler import build_layer
    with pytest.raises(NotImplementedError, match="polyphase"):
        build_layer(S.FusedConvPoolSpec(index=0, filters=4), {})


# --------------------------------------------- LatencyEngine vs JAX ---


@pytest.fixture
def interpret_b1():
    JBS._INTERPRET = True
    yield
    JBS._INTERPRET = False


def test_latency_engine_fused_matches_jax(interpret_b1):
    """Port LatencyEngine(fused_stem=True) against the JAX one at 128^2.

    Both run the bf16 chain, and its output is bf16, so the gates sit at
    the output's own resolution. The two frameworks sum in different
    orders, and on the CPU XLA keeps excess float32 precision across the
    JAX chain's bf16 round trips (allow_excess_precision), while the
    port rounds where the JAX source does; single-ulp flips therefore
    arise in every layer. Raw forward (random BN and biases): within
    2^-7, two bf16 ulps below 1. Detections: same classes and boxes
    within 2^-6 relative, at a threshold placed in a gap of the reference's
    candidate probs wider than the prob differences."""
    spec = JZ.tiny_yolo_voc(width=128, height=128)
    tspec = TZ.tiny_yolo_voc(width=128, height=128)
    params = random_bn(j_init_params(spec, seed=0), 1)
    jf = JLatency(spec, params, dtype=jnp.bfloat16, fused_stem=True)
    tf = LatencyEngine(tspec, params, device="cpu", fused_stem=True)
    assert jf.fused_stem and tf.fused_stem
    x = np.random.RandomState(1).uniform(0, 1, (1, 128, 128, 3)).astype(
        np.float32)
    oj, _ = jax.jit(jf._fwd)(jf.params, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        ot, _ = tf.forward(torch.from_numpy(x).to(torch.bfloat16))
    oj = np.asarray(oj, np.float32)
    ot = ot.float().numpy()
    np.testing.assert_allclose(ot, oj, rtol=0, atol=2 ** -7)
    assert np.mean(ot == oj) > 0.5

    params = random_bn(j_init_params(spec, seed=0), 1, head_gain=8.0)
    jf = JLatency(spec, params, dtype=jnp.bfloat16, fused_stem=True)
    tf = LatencyEngine(tspec, params, device="cpu", fused_stem=True)
    rng = np.random.RandomState(7)
    n_dets = 0
    for _ in range(3):
        frame = rng.randint(0, 255, tf.frame_shape, np.uint8)
        b0, p0 = (np.asarray(t, np.float32) for t in jf(frame))
        b1, p1 = (t.numpy() for t in tf(frame))
        best = np.sort(p0.max(-1))[::-1][:16]
        gap = int(np.argmax(best[:-1] - best[1:]))
        assert best[gap] - best[gap + 1] > 0.03
        thr = (best[gap] + best[gap + 1]) / 2

        def dets(bx, pr):
            keep = pr.max(-1) > thr
            order = np.lexsort(np.round(bx[keep], 2).T)
            return pr.argmax(-1)[keep][order], bx[keep][order]
        c0, g0 = dets(b0, p0)
        c1, g1 = dets(b1, p1)
        np.testing.assert_array_equal(c1, c0)
        # w, h = exp(raw) * anchor: a bf16 ulp in raw is 2^-7 relative
        np.testing.assert_allclose(g1, g0, rtol=2 ** -6, atol=1e-2)
        n_dets += len(c0)
    assert n_dets > 0


def test_latency_engine_fused_matches_plain():
    spec = TZ.tiny_yolo_voc(width=128, height=128)
    params = random_bn(init_params(spec, seed=2), 3, head_gain=8.0)
    fused = LatencyEngine(spec, params, device="cpu", fused_stem=True)
    plain = LatencyEngine(spec, params, device="cpu")
    assert fused.fused_stem and not plain.fused_stem
    frame = np.random.RandomState(3).randint(0, 255, (128, 128, 3),
                                             np.uint8)
    bf, pf = fused(frame)
    bp, pp = plain(frame)
    assert bf.shape == (64, 4) and pf.shape == (64, 20)
    assert np.isfinite(pf.numpy()).all()
    # same model, stem rounded once (fused) or twice (plain chain)
    np.testing.assert_allclose(np.sort(pf.max(-1).values.numpy()),
                               np.sort(pp.max(-1).values.numpy()),
                               atol=2e-2)


def test_latency_engine_frame_resize_and_errors():
    spec = TZ.tiny_yolo_voc(width=64, height=64)
    params = init_params(spec, seed=0)
    eng = LatencyEngine(spec, params, device="cpu", frame_hw=(48, 80))
    b, p = eng(np.zeros((48, 80, 3), np.uint8))
    assert b.shape == (20, 4) and p.shape == (20, 20)   # 2*2*5 < 64
    with pytest.raises(ValueError):
        eng(np.zeros((1, 48, 80, 3), np.uint8))
    # the int8 engine resizes the same way (calibrated on one frame)
    calib = np.random.RandomState(0).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    i8 = LatencyEngine(spec, params, device="cpu", frame_hw=(48, 80),
                       int8_calib=calib)
    b, p = i8(np.full((48, 80, 3), 128, np.uint8))
    assert b.shape == (20, 4) and p.shape == (20, 20)
    assert torch.isfinite(p).all()
    with pytest.raises(ValueError):
        i8(np.zeros((1, 48, 80, 3), np.uint8))


# ------------------------------------------------------------- server ---


def _serve(module, cfg, weights, frames, thresh):
    """Run a pipe server on the CPU; return (handshake, [(boxes, probs)])."""
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    res = subprocess.run(
        [sys.executable, "-m", module, cfg, weights, "--cpu"], input=req,
        capture_output=True, timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out = res.stdout
    hs = struct.unpack("<5i", out[:20])
    _, _, _, n_boxes, classes = hs
    per = 4 * (n_boxes * 4 + n_boxes * classes)
    assert len(out) == 20 + per * len(frames)
    replies = []
    for i in range(len(frames)):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        replies.append((blob[:n_boxes * 4].reshape(n_boxes, 4),
                        blob[n_boxes * 4:].reshape(n_boxes, classes)))
    return hs, replies


def test_serve_matches_jax_server(small_net):
    cfg, weights, _ = small_net
    rng = np.random.default_rng(10)
    frames = [rng.uniform(0, 1, (96, 112, 3)).astype(np.float32)
              for _ in range(2)]
    hs_t, rep_t = _serve("sr_object_detection_tpu_torch.infer.serve", cfg,
                         weights, frames, 0.05)
    hs_j, rep_j = _serve("sr_object_detection_tpu.infer.serve", cfg,
                         weights, frames, 0.05)
    assert hs_t == hs_j == (0x53524456, 128, 128, 4 * 4 * 5, 20)
    for (bt, pt), (bj, pj) in zip(rep_t, rep_j):
        np.testing.assert_allclose(bt, bj, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-5)
        assert (pt > 0).any()


def test_serve_refuses_int8_and_missing_gpu(small_net):
    """Without a CUDA device and without --cpu the server refuses to
    start, --int8 or not (its --int8 answers are held to the JAX server
    in tests/test_torch_int8_apps.py)."""
    cfg, weights, _ = small_net
    from sr_object_detection_tpu_torch.infer import serve
    if not torch.cuda.is_available():
        assert serve.main([cfg, weights]) == 2
        assert serve.main([cfg, weights, "--int8"]) == 2


# ------------------------------------------------------- JAX-free port ---


NO_JAX = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "sr_object_detection_tpu"):
    sys.modules[name] = None            # any import of these now raises
import numpy as np
import sr_object_detection_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from sr_object_detection_tpu_torch.infer.detector import Detector
from sr_object_detection_tpu_torch.io.weights import init_params, save_weights
from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
spec = tiny_yolo_voc(width=64, height=64)
save_weights(spec, init_params(spec, seed=0), sys.argv[2])
det = Detector(sys.argv[1], sys.argv[2], device="cpu")
dets = det.detect(np.full((64, 64, 3), 0.5, np.float32), thresh=0.0)
assert all(sys.modules.get(n) is None for n in ("jax", "jaxlib",
           "sr_object_detection_tpu"))
print(len(mods), len(dets))
"""


def test_port_runs_without_jax(tmp_path):
    cfg = tmp_path / "tiny64.cfg"
    cfg.write_text(_tiny_yolo_cfg_text(64))
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, str(cfg), str(tmp_path / "w.weights")],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    n_mods, n_dets = map(int, res.stdout.split())
    assert n_mods >= 20 and n_dets > 0


def test_port_sources_never_import_jax():
    """Every module of the port, and the files that run on the GPU
    machine (chip_smoke.py, the CUDA tests and their helpers)."""
    root = REPO / "sr_object_detection_tpu_torch"
    files = sorted(root.rglob("*.py"))
    names = {str(f.relative_to(root)) for f in files}
    assert {"infer/quant.py", "infer/engine.py", "kernels/phase_stem.py",
            "eval/voc.py", "apps/cli.py", "kernels/phase_train.py",
            "train/trainer.py", "train/region_loss.py", "train/sgd.py",
            "io/checkpoint.py", "data/loader.py", "data/augment.py",
            "apps/detector_app.py", "robot/pipeline.py",
            "apps/demo_app.py", "apps/robot_app.py", "io/surgery.py",
            "eval/reval_voc.py"} <= names
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
              REPO / "tests" / "torch_parity.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s.split("#")[0], (f, s)
                assert "sr_object_detection_tpu " not in s + " ", (f, s)
                assert "sr_object_detection_tpu." not in s, (f, s)
