"""The port's robot layer on the CPU: ``robot/*`` (byte-equal copies of
the JAX package's, tests/test_torch_host.py) run as the JAX package's
tests/test_robot.py, test_file_protocol.py and test_action_interaction.py
run them, the numpy modules held equal to the JAX package's results, and
the frame loop with the port's Detector against the same loop with the
JAX package's Detector.

The native library is built from a copy of ``native/`` in a temporary
directory and the port's binding pointed at it, so this file never runs
``make`` in ``native/`` (tests/test_robot.py builds there).
"""

import json
import os
import pathlib
import shutil
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import sr_object_detection_tpu.robot.action as JA
import sr_object_detection_tpu.robot.interaction as JI
import sr_object_detection_tpu.robot.registration as JR
from sr_object_detection_tpu.infer.detector import Detector as JDetector
from sr_object_detection_tpu.robot import frame_source as JFS
import sr_object_detection_tpu_torch.robot.action as TA
import sr_object_detection_tpu_torch.robot.interaction as TI
import sr_object_detection_tpu_torch.robot.registration as TR
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.infer.detector import Detection, Detector
from sr_object_detection_tpu_torch.robot import body_viz, native
from sr_object_detection_tpu_torch.robot.file_protocol import (
    FileProtocolDetector, read_detection_txt, write_detection_txt,
    write_speech_txt)
from sr_object_detection_tpu_torch.robot.frame_source import (
    RawRGBDSource, SyntheticRGBDSource, V4L2FrameSource, VideoFileSource)
from sr_object_detection_tpu_torch.robot.pipeline import (
    NLWriter, RobotPerception)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
sys.path.insert(0, str(REPO / "tests"))
from test_action_interaction import _make_clip  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def native_lib(tmp_path_factory):
    """libsr_robot.so built from a copy of native/ in a temporary
    directory; the port's binding loads it from there."""
    src = tmp_path_factory.mktemp("native") / "native"
    shutil.copytree(REPO / "native", src,
                    ignore=shutil.ignore_patterns("build", "*.o"))
    subprocess.run(["make", "-C", str(src)], check=True,
                   capture_output=True)
    saved = native._LIB_PATH, native._lib
    native._LIB_PATH = src / "build" / "libsr_robot.so"
    native._lib = None
    yield native._LIB_PATH
    native._LIB_PATH, native._lib = saved


def _det(x, y, w=0.1, h=0.1, cls=0, prob=0.9, cam=(0, 0, 0)):
    return {"box": (x, y, w, h), "prob": prob, "class_id": cls,
            "cam": cam, "body_id": -1}


# ------------------------------------------------------- native runtime

def test_native_binds_the_built_library(native_lib):
    assert pathlib.Path(native.lib()._name) == native_lib


def test_object_memory_vote_reminder_and_ema():
    om = native.ObjectMemory(appear=3, disappear=2)
    for _ in range(2):
        om.update([_det(0.5, 0.5)])
        assert len(om.objects()) == 0
    om.update([_det(0.5, 0.5)])
    assert len(om.objects()) == 1
    for _ in range(4):
        om.update([])
    rem = om.reminders()
    assert len(rem) == 1 and abs(rem[0]["box"][0] - 0.5) < 0.05
    assert len(om.objects()) == 0
    om = native.ObjectMemory(appear=1, disappear=5, ema=0.8)
    om.update([_det(0.50, 0.50, w=0.2, h=0.2)])
    om.update([_det(0.55, 0.50, w=0.2, h=0.2)])
    assert 0.505 < om.objects()[0]["box"][0] < 0.52


def test_multitracker_localize_plane_fhog_kcf():
    mt = native.MultiTracker()
    d1 = mt.update([_det(0.3, 0.3), _det(0.7, 0.7, cls=1)], 100, 100)
    d2 = mt.update([_det(0.31, 0.31), _det(0.69, 0.71, cls=1)], 100, 100)
    assert ({d["class_id"]: d["body_id"] for d in d1}
            == {d["class_id"]: d["body_id"] for d in d2})
    depth = np.zeros((100, 100), np.uint16)
    depth[40:60, 40:60] = 2000
    cam = native.localize(depth, (100.0, 100.0, 50.0, 50.0),
                          [_det(0.5, 0.5, 0.2, 0.2)])[0]["cam"]
    assert abs(cam[2] - 2.0) < 1e-3 and abs(cam[0]) < 0.02
    rng = np.random.default_rng(0)
    ground = np.stack([rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500),
                       1.5 + rng.normal(0, 0.002, 500)], axis=1)
    pts = np.concatenate([ground, rng.normal([0.2, 0, 1], 0.05, (60, 3))])
    plane, mask, inl = native.plane_ransac(pts.astype(np.float32),
                                           dist_thresh=0.02, max_iters=300,
                                           seed=1)
    assert inl > 450 and abs(abs(plane[2]) - 1.0) < 0.05
    f = SyntheticRGBDSource().next()
    d = f.depth.copy()
    table = int((d == 1500).sum())
    assert native.remove_plane(d, f.intrinsics, dist_thresh=0.03,
                               max_iters=300, seed=3) > 0.8 * table
    hog = native.fhog(rng.random((64, 64, 3)).astype(np.float32), cell=4)
    assert hog.shape == (16, 16, 31) and np.isfinite(hog).all()
    texture = (rng.random((24, 24, 3)) * 255).astype(np.uint8)

    def frame(ox, oy):
        img = np.full((120, 160, 3), 30, np.uint8)
        img[oy:oy + 24, ox:ox + 24] = texture
        return img
    t = native.KCFTracker()
    t.init(frame(40, 50), (40, 50, 24, 24))
    for i in range(1, 8):
        box = t.track(frame(40 + 2 * i, 50 + i))
    assert abs(box[0] + box[2] / 2 - 66) < 6
    assert abs(box[1] + box[3] / 2 - 69) < 6


# ---------------------------------------------------------- the loop

class FakeDetector:
    """tests/test_robot.py's: the red and green boxes of
    SyntheticRGBDSource."""

    def detect(self, img, thresh=0.24, nms=0.1):
        h, w = img.shape[:2]
        out = []
        for mask, cls in (((img[..., 0] > 0.6) & (img[..., 1] < 0.3), 0),
                          ((img[..., 1] > 0.6) & (img[..., 0] < 0.3), 1)):
            ys, xs = np.nonzero(mask)
            if len(xs) >= 10:
                out.append(Detection(
                    ((xs.min() + xs.max()) / 2 / w,
                     (ys.min() + ys.max()) / 2 / h,
                     (xs.max() - xs.min() + 1) / w,
                     (ys.max() - ys.min() + 1) / h), cls, 0.9))
        return out


def test_nl_writer_and_full_pipeline(tmp_path):
    nl = NLWriter(str(tmp_path / "o.txt"))
    assert nl.write([]) == "i can not see anything"
    assert nl.write(["cup", "bottle", "cup"]) == \
        "i can see a cup and a bottle"
    msgs = []
    pipe = RobotPerception(FakeDetector(), names=["redbox", "greenbox"],
                           nl_path=str(tmp_path / "Objects.txt"),
                           ipc=msgs.append, detect_every=3)
    results = pipe.run(SyntheticRGBDSource(n_frames=12))
    assert len(results) == 12
    assert all(len(r["detections"]) >= 1 for r in results[1:])
    last = results[-1]
    assert {o["name"] for o in last["objects"]} == {"redbox", "greenbox"}
    green = [o for o in last["objects"] if o["name"] == "greenbox"][0]
    assert abs(green["cam"][2] - 0.8) < 0.05
    assert msgs and msgs[-1]["type"] == "objectRecognized"


def test_pipeline_action_recognition():
    cfg = TA.HistogramConfig()
    xs, ys = [], []
    for label, kind in enumerate(["wave", "walk"]):
        for s in range(10):
            xs.append(TA.motion_histograms(_make_clip(kind, seed=s), cfg))
            ys.append(label)
    model = TA.ELM(hidden=64, seed=1).fit(np.stack(xs), np.asarray(ys), 2)
    pipe = RobotPerception(FakeDetector(), names=["redbox", "greenbox"],
                           action_recognizer=TA.ActionRecognizer(
                               model, ["wave", "walk"], cfg))
    clip = _make_clip("wave", seed=321)
    acts = []
    for i, frame in enumerate(SyntheticRGBDSource(n_frames=len(clip) + 2)):
        frame.skeletons = {7: clip[i]} if i < len(clip) else {}
        acts += pipe.process(frame)["actions"]
    assert [(a["body_id"], a["action"]) for a in acts] == [(7, "wave")]


@pytest.fixture(scope="module")
def ab_model(tmp_path_factory):
    """The map_ab model: trained on red, green and blue boxes, which the
    synthetic RGB-D frames show."""
    d = tmp_path_factory.mktemp("ab")
    g = np.load(GOLDEN / "map_ab.npz")
    (d / "net.cfg").write_text(bytes(g["cfg"]).decode())
    (d / "w.weights").write_bytes(bytes(g["weights"]))
    (d / "ab.names").write_text("red\ngreen\nblue\n")
    return str(d / "net.cfg"), str(d / "w.weights"), str(d / "ab.names")


def _run_loop(det, n_frames=8, thresh=0.02):
    """RobotPerception over synthetic RGB-D frames, a detect frame every
    other frame; the map_ab model's probs on them lie below 0.06."""
    pipe = RobotPerception(det, names=["red", "green", "blue"],
                           detect_every=2, thresh=thresh, nms=0.1)
    return pipe.run(SyntheticRGBDSource(n_frames=n_frames))


def test_pipeline_real_detector_matches_jax(ab_model):
    """The frame loop with the port's Detector (CPU) and with the JAX
    package's on the same cfg and weights: equal sentences and class
    ids each frame, boxes within 1e-5."""
    cfg, weights, _ = ab_model
    got = _run_loop(Detector(cfg, weights, device="cpu"))
    want = _run_loop(JDetector(cfg, weights))
    assert sum(len(r["detections"]) for r in want) > 0
    for g, w in zip(got, want):
        assert g["sentence"] == w["sentence"]
        for key in ("detections", "objects", "reminders"):
            assert [d["class_id"] for d in g[key]] == [
                d["class_id"] for d in w[key]]
            for a, b in zip(g[key], w[key]):
                np.testing.assert_allclose(a["box"], b["box"], rtol=1e-5,
                                           atol=1e-5)
    assert any(r["sentence"] != "i can not see anything" for r in want)


def test_cli_robot_run(ab_model, native_lib, tmp_path, capsys,
                       monkeypatch):
    """`robot run` through the port's CLI (-cpu) and the JAX package's on
    the same arguments: -source over map_ab frames (one image five
    times, so the object memory votes it in, then another), -faces,
    -ipc, -detect-every. Equal printed lines, sentences, class ids,
    faces and IPC messages, boxes within 1e-5, and some objects seen."""
    from sr_object_detection_tpu.apps import cli as JCLI
    from sr_object_detection_tpu.robot import native as JN
    from tools.synth_dataset import make_dataset
    monkeypatch.setattr(JN, "_LIB_PATH", native_lib)
    monkeypatch.setattr(JN, "_lib", None)
    cfg, weights, names = ab_model
    g = np.load(GOLDEN / "map_ab.npz")
    src = open(make_dataset(str(tmp_path / "src"), 2, int(g["seed"]))[0]
               ).read().split()
    (tmp_path / "frames").mkdir()
    for i in range(8):
        shutil.copy(src[i >= 5], tmp_path / "frames" / f"f{i:03d}.ppm")

    def run(cli, tag, extra):
        res = cli.cmd_robot([
            "run", cfg, weights, "-source", str(tmp_path / "frames" /
                                                "*.ppm"),
            "-frames", "8", "-names", names, "-detect-every", "2",
            "-faces", "-ipc", str(tmp_path / f"ipc-{tag}.jsonl"),
            "-nl", str(tmp_path / f"Objects-{tag}.txt")] + extra)
        ipc = [json.loads(l) for l in
               (tmp_path / f"ipc-{tag}.jsonl").read_text().splitlines()]
        for m in ipc:
            m.pop("t")
        return (res, capsys.readouterr().out.splitlines(), ipc,
                (tmp_path / f"Objects-{tag}.txt").read_text())

    got, want = run(TCLI, "port", ["-cpu"]), run(JCLI, "jax", [])
    res = got[0]
    assert len(res) == 8 and all("faces" in r for r in res)
    assert [l.split(":")[0] for l in got[1]] == [f"frame {i}" for i in
                                                 range(8)]
    assert got[1:] == want[1:]
    assert got[3].strip() == res[-1]["sentence"]
    assert any(r["sentence"] != "i can not see anything" for r in res)
    assert got[2]
    for a, b in zip(res, want[0]):
        assert a["sentence"] == b["sentence"] and a["faces"] == b["faces"]
        for key in ("detections", "objects", "reminders"):
            assert [d["class_id"] for d in a[key]] == [
                d["class_id"] for d in b[key]]
            for da, db in zip(a[key], b[key]):
                np.testing.assert_allclose(da["box"], db["box"], rtol=1e-5,
                                           atol=1e-5)
    assert sum(len(r["detections"]) for r in res) > 0


# ---------------------------------------------------- frame sources

def test_frame_sources_match_jax(tmp_path):
    f = SyntheticRGBDSource(n_frames=2).next()
    g = JFS.SyntheticRGBDSource(n_frames=2).next()
    np.testing.assert_array_equal(f.color, g.color)
    np.testing.assert_array_equal(f.depth, g.depth)
    RawRGBDSource.write_frame(str(tmp_path / "000"), f)
    back = RawRGBDSource(str(tmp_path)).next()
    np.testing.assert_array_equal(back.color, f.color)
    np.testing.assert_array_equal(back.depth, f.depth)


def test_video_file_source_gif(tmp_path):
    from PIL import Image
    frames = []
    for t in range(5):
        a = np.zeros((32, 48, 3), np.uint8)
        a[:, (t * 9) % 48:(t * 9) % 48 + 6] = (255, 0, 0)
        frames.append(Image.fromarray(a))
    vid = tmp_path / "clip.gif"
    frames[0].save(vid, save_all=True, append_images=frames[1:],
                   duration=50, loop=0)
    got = list(VideoFileSource(str(vid)))
    want = list(JFS.VideoFileSource(str(vid)))
    assert len(got) == 5 and got[0].color.shape == (32, 48, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.color, b.color)


def test_v4l2_frame_source_mocked_device(tmp_path, monkeypatch):
    w, h, n = 64, 48, 3
    fake = tmp_path / "ffmpeg"
    fake.write_text(
        "#!/usr/bin/env python3\n"
        "import os\n"
        "out = os.fdopen(1, 'wb')\n"
        f"for t in range({n}):\n"
        f"    out.write(bytes([t*40 % 256]) * ({w}*{h}*3))\n"
        "out.close()\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}" + os.environ["PATH"])
    src = V4L2FrameSource(width=w, height=h,
                          _input_args=["-f", "lavfi", "-i", "testsrc"])
    got = list(src)
    assert len(got) == n and got[0].color.shape == (h, w, 3)
    assert not np.array_equal(got[0].color, got[2].color)
    src.close()
    with pytest.raises(RuntimeError, match="no camera device"):
        V4L2FrameSource("/dev/video99")


# ------------------------------------------------------ file protocol

def test_file_protocol_roundtrip_and_sentences(tmp_path):
    p = str(tmp_path / "test.txt")
    dets = [Detection((0.5, 0.5, 0.2, 0.3), 1, 0.87, "cup"),
            Detection((0.25, 0.75, 0.1, 0.1), 0, 0.55, "bottle")]
    write_detection_txt(p, dets, 640, 480)
    lines = open(p).read().splitlines()
    assert lines[0] == "objNumber = 2"
    assert [l.split(" = ")[0] for l in lines[2:9]] == [
        "x", "y", "w", "h", "name", "prob", "objClass"]
    got = read_detection_txt(p, 640, 480)
    assert not os.path.exists(p)
    for a, b in zip(dets, got):
        assert (b.class_id, b.name) == (a.class_id, a.name)
        np.testing.assert_allclose(b.box, a.box, atol=1e-3)
    assert read_detection_txt(p, 640, 480, timeout=0.05) == []
    s = write_speech_txt(p, ["cup", "tv", "cup", "chair"])
    assert s == ("there are many things in this room. i can see cup, "
                 "tv and chair.")


def test_pipeline_with_no_model(tmp_path):
    """The speech-api deployment: detections from another process
    through the shared file, no model in this one."""
    p = str(tmp_path / "test.txt")
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            write_detection_txt(
                p, [Detection((0.35, 0.4, 0.2, 0.2), 0, 0.9)], 96, 96)
            time.sleep(0.002)
    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        pipe = RobotPerception(FileProtocolDetector(p, timeout=2.0),
                               names=["redbox", "greenbox"])
        results = pipe.run(SyntheticRGBDSource(n_frames=10))
    finally:
        stop.set()
        t.join(timeout=2)
    assert not t.is_alive() and len(results) == 10
    assert any(o["name"] == "redbox" for r in results for o in r["objects"])


# --------------------------------------- action, interaction, registration

def test_action_features_and_elm_match_jax():
    cfg_t, cfg_j = TA.HistogramConfig(), JA.HistogramConfig()
    xs_t, xs_j, ys = [], [], []
    for label, kind in enumerate(["wave", "walk", "still"]):
        for s in range(6):
            clip = _make_clip(kind, seed=s)
            xs_t.append(TA.motion_histograms(clip, cfg_t))
            xs_j.append(JA.motion_histograms(clip, cfg_j))
            ys.append(label)
    np.testing.assert_array_equal(np.stack(xs_t), np.stack(xs_j))
    mt = TA.ELM(hidden=64, seed=0).fit(np.stack(xs_t), np.asarray(ys), 3)
    mj = JA.ELM(hidden=64, seed=0).fit(np.stack(xs_j), np.asarray(ys), 3)
    probe = TA.motion_histograms(_make_clip("wave", seed=77), cfg_t)[None]
    np.testing.assert_array_equal(mt.predict(probe), mj.predict(probe))
    rng = np.random.default_rng(1)
    prev = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    cur = np.roll(prev, (2, -3), axis=(0, 1))
    d = np.full((64, 64), 1500.0, np.float32)
    for a, b in zip(TA.scene_flow(prev, cur, d, d + 40, block=16, search=4),
                    JA.scene_flow(prev, cur, d, d + 40, block=16,
                                  search=4)):
        np.testing.assert_array_equal(a, b)


def test_interaction_and_body_viz():
    body = np.full((100, 100), 255, np.uint8)
    body[20:60, 20:60] = 2
    for mod in (TI, JI):
        assert mod.associate_person((0.4, 0.4, 0.3, 0.3), body) == 2
        assert mod.associate_person((0.9, 0.9, 0.1, 0.1), body) == -1
    img = np.zeros((96, 96, 3), np.float32)
    img[..., 2] = 0.8
    yy, xx = np.mgrid[:96, :96]
    for cx in (24, 72):
        img[((yy - 30) ** 2 + (xx - cx) ** 2) < 121] = [0.85, 0.6, 0.45]
    assert TI.heuristic_face_count(img) == JI.heuristic_face_count(img) == 2
    said = []
    sp = TI.Speaker(sink=said.append)
    assert sp.speak("hello") and not sp.speak("hello")
    crop, (x0, y0) = TI.hand_roi(np.zeros((100, 200, 3), np.uint8),
                                 (195, 95), roi_size=64)
    assert crop.shape == (64, 64, 3) and (x0, y0) == (136, 36)
    im = np.zeros((120, 120, 3), np.float32)
    joints = np.full((25, 2), 60, np.float32)
    joints[3], joints[2], joints[7], joints[11] = [60, 15], [60, 25], \
        [25, 50], [95, 50]
    body_viz.draw_body(im, joints, np.full(25, 2), hand_left="open",
                       hand_right="closed")
    assert np.allclose(im[50, 25], body_viz.HAND_COLORS["open"])
    assert im[0, 0].sum() == 0


def test_registration_matches_jax():
    cam_t = TR.CameraModel(100.0, 100.0, 64.0, 64.0, 128, 128)
    cam_j = JR.CameraModel(100.0, 100.0, 64.0, 64.0, 128, 128)
    t = np.array([-0.05, 0.0, 0.0], np.float32)
    rt = TR.Registration(color=cam_t, depth=cam_t, t_depth_to_color=t)
    rj = JR.Registration(color=cam_j, depth=cam_j, t_depth_to_color=t)
    depth = np.full((128, 128), 2000, np.uint16)
    dpx = np.array([[64.0, 64.0], [10.0, 100.0]], np.float32)
    z = np.array([2.0, 2.0], np.float32)
    cpx = rt.depth_px_to_color_px(dpx, z)
    np.testing.assert_array_equal(cpx, rj.depth_px_to_color_px(dpx, z))
    assert abs(cpx[0, 0] - 61.5) < 0.1
    np.testing.assert_array_equal(rt.color_px_to_depth_px(cpx, depth),
                                  rj.color_px_to_depth_px(cpx, depth))
    np.testing.assert_array_equal(
        rt.color_box_to_depth((0.5, 0.5, 0.2, 0.2), depth),
        rj.color_box_to_depth((0.5, 0.5, 0.2, 0.2), depth))
