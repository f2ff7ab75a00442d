"""The port's JAX-free host modules against their JAX-package originals.

``sr_object_detection_tpu_torch`` carries its own copies of config.py,
graph/spec.py, io/weights.py, models/zoo.py, eval/voc.py,
data/augment.py and io/tree.py, because the
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
          "eval/voc.py", "data/augment.py", "io/tree.py", "ops/draw.py"] + [
    f"robot/{m}.py" for m in ("registration", "body_viz", "action",
                              "interaction", "native", "frame_source",
                              "file_protocol", "pipeline")]


# functions copied as they are into modules that also hold torch code
FUNCTION_COPIES = [
    ("ops/image.py", n) for n in ("_resize_coeffs", "resize_image_np",
                                  "letterbox_dims", "letterbox_image_np",
                                  "load_image_u8", "_load_pnm",
                                  "crop_image_np", "resize_min_np")] + [
    ("data/loader.py", n) for n in ("label_path_for",
                                    "load_classification_sample",
                                    "load_cifar10_batch",
                                    "fill_hierarchy")] + [
    ("io/surgery.py", n) for n in ("partial", "average", "_tree_add",
                                   "_tree_scale", "rescale_net", "rescale",
                                   "rgbgr_net", "normalize_net",
                                   "statistics", "transfer",
                                   "reset_normalize_net")] + [
    ("apps/nightmare_app.py", "_save_ppm")] + [
    ("apps/cli.py", n) for n in ("find_arg", "find_value", "_load_net",
                                 "cmd_partial", "cmd_average",
                                 "_surgery_cmd", "cmd_statistics",
                                 "cmd_visualize", "cmd_oneoff")] + [
    ("eval/reval_voc.py", n) for n in ("read_det_file", "gt_from_xml")] + [
    ("apps/rnn_app.py", n) for n in ("VOCAB", "CharStream")] + [
    ("apps/misc_apps.py", n) for n in ("VOC_NAMES", "decode_detection_boxes",
                                       "fill_truth_region_np", "NUMCHARS",
                                       "_int_to_alphanum", "DICE_LABELS",
                                       "composite_3d", "imtest",
                                       "_dist_array", "best_3d_shift_r",
                                       "_frame_iter", "extract_voxel")] + [
    ("apps/yolo_v1_app.py", n) for n in ("COCO_IDS", "_iou_centers")] + [
    ("apps/go_app.py", n) for n in (
        "BOARD", "N", "NIND", "KOMI", "RECORD", "load_go_moves",
        "string_to_board", "board_to_string", "random_go_moves",
        "_group_and_liberties", "move_go", "suicide_go", "legal_go",
        "_gnugo_available", "tromp_taylor_score", "_gnugo_game_lines",
        "score_game", "_dihedral", "_dihedral_inv", "format_board",
        "_apply_test_input", "_VALUE_FLAGS", "_positionals")] + [
    ("apps/misc_train.py", n) for n in (
        "SECRET_NUM", "_read_list", "_find_replace_path", "_train_loop",
        "_load_resized", "fix_data_captcha", "load_tags", "_load_gray",
        "load_compare_labels", "FrameDirVideos", "DICE_LABELS")] + [
    ("apps/compare_app.py", "_elo_update")] + [
    ("utils/profiler.py", n) for n in ("StepTimer", "MetricsLog",
                                       "train_flops")] + [
    ("utils/gemm_bench.py", "DARKNET_SHAPES")]
# a copy whose original lies outside the JAX package
ORIGINALS = {"eval/reval_voc.py": REPO / "tools" / "reval_voc.py"}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    orig = (REPO / "sr_object_detection_tpu" / rel).read_bytes()
    copy = (REPO / "sr_object_detection_tpu_torch" / rel).read_bytes()
    assert copy == orig, f"{rel} drifted from the JAX package's original"


def _function_source(path, name):
    """The source of a module's top-level function, class or assignment
    ``name``, its leading comments included."""
    import ast
    text = path.read_text()

    def names(n):
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            return [n.name]
        if isinstance(n, ast.Assign):
            return [t.id for t in n.targets if isinstance(t, ast.Name)]
        return []
    node = next(n for n in ast.parse(text).body if name in names(n))
    lines = text.splitlines()
    start = node.lineno - 1
    while start > 0 and lines[start - 1].startswith("#"):
        start -= 1
    return "\n".join(lines[start:node.lineno - 1] + [
        ast.get_source_segment(text, node)])


@pytest.mark.parametrize("rel,name", FUNCTION_COPIES)
def test_function_copy_is_verbatim(rel, name):
    orig = _function_source(
        ORIGINALS.get(rel, REPO / "sr_object_detection_tpu" / rel), name)
    copy = _function_source(REPO / "sr_object_detection_tpu_torch" / rel,
                            name)
    assert copy == orig, f"{rel}:{name} drifted from the JAX original"


def test_reval_voc_differs_only_in_its_imports():
    """eval/reval_voc.py is tools/reval_voc.py with the port's mean_ap and
    load_image_u8, without the sys.path entry the tool needs to find the
    JAX package; the code after the module docstring is otherwise the
    same."""
    def body(path):
        text = path.read_text()
        return text[text.index('"""', text.index('"""') + 3) + 3:]
    orig = body(REPO / "tools" / "reval_voc.py")
    copy = body(REPO / "sr_object_detection_tpu_torch" / "eval"
                / "reval_voc.py")
    orig = (orig.replace("import sys\n", "")
            .replace("sys.path.insert(0, os.path.dirname(os.path.dirname(\n"
                     "    os.path.abspath(__file__))))\n\n\n", "\n")
            .replace("from sr_object_detection_tpu.",
                     "from sr_object_detection_tpu_torch."))
    assert copy == orig


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


# a seeded CRNN net (two steps of two streams at 8x8) with a cost head
CRNN_NET = """
[net]
batch=2
time_steps=2
subdivisions=1
height=8
width=8
channels=3

[crnn]
batch_normalize=1
output_filters=6
hidden_filters=5
activation=leaky

[connected]
output=5
activation=linear

[cost]
type=sse
"""


@pytest.mark.parametrize("net", ["char_rnn", "crnn"])
def test_weights_byte_equal(net, tmp_path):
    """A seeded char_rnn (vocab 256, hidden 32) and a seeded CRNN net, whose
    params are one dict a sublayer: the port's ``export_weights`` of a
    Trainer's state writes the JAX package's ``save_weights`` bytes, the
    train state's npz keys and arrays are JAX's, and the port reads JAX's
    npz back."""
    import sr_object_detection_tpu.io.checkpoint as JCK
    import sr_object_detection_tpu.train.trainer as JT
    import sr_object_detection_tpu_torch.io.checkpoint as TCK
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    from torch_parity import random_bn_nested
    if net == "char_rnn":
        spec, jspec = TZ.char_rnn(hidden=32), JZ.char_rnn(hidden=32)
    else:
        spec = TS.build_network_spec(TC.parse_cfg_text(CRNN_NET))
        jspec = JS.build_network_spec(JC.parse_cfg_text(CRNN_NET))
    params = random_bn_nested(TW.init_params(spec, seed=21), 22)
    tt = Trainer(spec, params=params, device="cpu")
    TCK.export_weights(str(tmp_path / "port.weights"), spec, tt.state)
    JW.save_weights(jspec, params, str(tmp_path / "jax.weights"), seen=0)
    assert (tmp_path / "port.weights").read_bytes() == \
        (tmp_path / "jax.weights").read_bytes()
    TCK.save_train_state(str(tmp_path / "port.npz"), tt.state, spec)
    JCK.save_train_state(str(tmp_path / "jax.npz"),
                         JT.Trainer(jspec, params=params).state)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    assert any(k.count("/") == 3 for k in b.files)   # p/<layer>/<sub>/<name>
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = TCK.load_train_state(str(tmp_path / "jax.npz"), tt.state, spec)
    for p, q in zip(back.params, tt.state.params):
        assert p.keys() == q.keys()
        for k, v in q.items():
            assert torch.equal(p[k], v), k


def test_cli_has_every_jax_command():
    """The port's CLI dispatches every command of the JAX package's."""
    from sr_object_detection_tpu.apps import cli as JCLI
    from sr_object_detection_tpu_torch.apps import cli as TCLI
    assert set(JCLI.COMMANDS) <= set(TCLI.COMMANDS)
