"""darknet-compatible CLI.

Counterpart of ``sr_object_detection_tpu/apps/cli.py``
(src_yolo2/darknet.c:98-499 surface), run as
``python -m sr_object_detection_tpu_torch.apps.cli <command> ...``:

  detect <cfg> <weights> <image> [-thresh T] [-names FILE] [-out out.ppm]
      [-int8 [-qhead]] [-presplit] [-cpu]
  classify <cfg> <weights> <image> [-int8] [-names FILE] [-cpu]
  classifier train|predict|try|valid|valid_multi|valid_crop|valid_full|
      valid_10|test|label|demo|threat|gun <data> <cfg> [weights] ... [-cpu]
  cifar train|distill|test|multi|csv|csvtrain <cfg> [weights] -data <dir>
      ... [-cpu]
  cifar eval|extract -data <dir> ...
  detector train|valid|recall <data> <cfg> [weights] ... [-cpu]
  detector test <data> <cfg> <weights> <image> ...   (= detect)
  detector demo <data> <cfg> <weights> [-frames glob|-video f|-cam i] [-cpu]
  robot run <cfg> <weights> [-source synthetic|<glob>] ... [-cpu]
  rnn train|generate|generatetactic|valid|validtactic|vec <cfg> ... [-cpu]
  yolo|coco|swag train <data> <cfg> [weights] [-cpu]
  yolo|coco|swag test|valid|recall|demo <cfg> [weights] ... [-cpu]
  nightmare <cfg> <weights> <image> <layer> [-iters n] ... [-cpu]
  super [test] <cfg> <weights> <image> [-out path] [-cpu]
  super train <cfg> [weights] -list <list> [-scale s] [-backup dir] [-cpu]
  go train|valid|test|self|engine <cfg> [weights] ... [-multi] [-cpu]
  captcha train|valid <cfg> [weights] -list <list> -labels <list> [-cpu]
  captcha test <cfg> [weights] <image> -labels <list> [-cpu]
  captcha|art <cfg> <weights> <image> [-cpu]
  tag train <cfg> [weights] -list <list> [-cpu]
  tag <cfg> <weights> <image> [-names FILE] [-cpu]
  writing train <cfg> [weights] -list <list> [-cpu]
  writing <cfg> <weights> <image> [-out out.ppm] [-cpu]
  compare train|valid|sort|battle <cfg> [weights] -list <list> ... [-cpu]
  compare <cfg> <weights> <image a> <image b> [-cpu]
  dice train|valid <cfg> [weights] -list <list> [-cpu]
  dice [test] <cfg> <weights> <image> [-cpu]
  voxel train <cfg> [weights] -list <list> [-cpu]
  voxel extract <left> <right> <prefix> [-w W -h H -xoff X]
  voxel [test] <cfg> <weights> <frame glob> [-out dir] [-cpu]
  vid train <cfg> [weights] -list <dirs> -extractor <cfg> [-cpu]
  vid generate <cfg> [weights] -extractor <cfg> -frames <src> ... [-cpu]
  vid <cfg> [weights] -frames <glob> [-cpu]
  3d <left> <right> [out.ppm] [-delta d]
  imtest|test <image> [-out dir]
  gemm [m k n] [-reps N] [-f32] [-cpu]
  speed <cfg> [tics] [-batch N] [-int8 [-phase-stem] [-qhead]] [-cpu]
  ops <cfg>
  partial <cfg> <weights> <out> <n>
  average <cfg> <out> <w1> <w2> ...
  oneoff <src cfg> <weights> <dst cfg> <out>
  rescale|reset|rgbgr|denormalize|normalize <cfg> <weights> <out>
  statistics <cfg> <weights>
  visualize <cfg> [weights]

Every command that runs a network (and `gemm`) runs on CUDA unless
-cpu is given; the weight-surgery and inspection commands, `3d`,
`imtest` / `test` and `voxel extract` run on the host in numpy (they
take -cpu and ignore it). Flag parsing follows the reference's
argv-splicing helpers (utils.c:62-118): '-key value' pairs are plucked
from anywhere.
"""

from __future__ import annotations

import sys
import time


def find_arg(argv, key):
    if key in argv:
        argv.remove(key)
        return True
    return False


def find_value(argv, key, default=None, cast=str):
    if key in argv:
        i = argv.index(key)
        v = argv[i + 1]
        del argv[i:i + 2]
        return cast(v)
    return default


def _load_net(cfg, weights):
    from ..graph.spec import parse_network_cfg
    from ..io.weights import load_weights, init_params
    spec = parse_network_cfg(cfg)
    if weights:
        params, seen = load_weights(spec, weights)
    else:
        params, seen = init_params(spec), 0
    return spec, params, seen


def _device(argv):
    """"cpu" when argv holds -cpu (taken out), else "cuda"."""
    return "cpu" if find_arg(argv, "-cpu") else "cuda"


def cmd_detect(argv):
    thresh = find_value(argv, "-thresh", 0.24, float)
    out_path = find_value(argv, "-out", None)
    names_file = find_value(argv, "-names", None)
    use_int8 = find_arg(argv, "-int8")
    use_presplit = find_arg(argv, "-presplit")
    use_qhead = find_arg(argv, "-qhead")   # int8 head conv too
    device = _device(argv)
    cfg, weights, image = argv[0], argv[1], argv[2]
    from ..config import read_names
    from ..infer.detector import Detector
    from ..ops.image import load_image_rgb
    names = read_names(names_file) if names_file else None
    img = load_image_rgb(image)
    calib = None
    if use_int8:
        # int8 serving mode (infer/quant.py): calibrate activation
        # scales on the input image itself
        from ..graph.spec import parse_network_cfg
        from ..ops.image import resize_image_np
        _spec = parse_network_cfg(cfg)
        calib = resize_image_np(img, _spec.net.w, _spec.net.h)[None]
    det = Detector(cfg, weights, names=names, int8_calib=calib,
                   presplit=use_presplit, quantize_head=use_qhead,
                   device=device)
    t0 = time.time()
    dets = det.detect(img, thresh=thresh)
    print(f"{image}: Predicted in {time.time()-t0:.6f} seconds.")
    for d in dets:
        label = d.name or str(d.class_id)
        print(f"{label}: {100*d.prob:.0f}%  box={d.box}")
    if out_path:
        # draw_detections + save_image analog (image.c:741,1397)
        from ..ops.draw import draw_detections
        from .nightmare_app import _save_ppm
        _save_ppm(out_path, draw_detections(
            img, dets, classes=det.region.classes))
        print(f"wrote {out_path}")
    return dets


def cmd_classify(argv):
    use_int8 = find_arg(argv, "-int8")
    names_file = find_value(argv, "-names", None)
    device = _device(argv)
    cfg, weights, image = argv[0], argv[1], argv[2]
    from ..config import read_names
    from ..infer.classifier import Classifier
    from ..ops.image import load_image_rgb
    names = read_names(names_file) if names_file else None
    img = load_image_rgb(image)
    clf = Classifier(cfg, weights, names=names,
                     device=device)
    if use_int8:
        # int8 serving mode: calibrate on the letterboxed input image
        clf.quantize(clf.preprocess(img)[None])
    top = clf.predict_topk(img, k=5)
    for idx, p, name in top:
        print(f"{name or idx}: {p:.6f}")
    return top


def cmd_speed(argv):
    """darknet.c:98-113: time `tics` forwards, print sec/eval and Hz.
    `-batch N` widens the eval; `-int8` uses the quantized engine;
    `-phase-stem` (with -int8 -batch 128) runs the leading
    conv3x3+pool2x2 pairs through the int8 stem kernel
    (kernels/phase_stem.py, bit-exact to the int8 chain)."""
    use_int8 = find_arg(argv, "-int8")
    use_presplit = "flat" if find_arg(argv, "-presplit-flat") \
        else find_arg(argv, "-presplit")
    use_qhead = find_arg(argv, "-qhead")
    use_phase = find_arg(argv, "-phase-stem")
    device = _device(argv)
    batch = find_value(argv, "-batch", 1, int)
    cfg = argv[0]
    tics = int(argv[1]) if len(argv) > 1 else 20
    from ..graph.spec import parse_network_cfg
    from ..infer.engine import ThroughputEngine
    from ..io.weights import init_params
    spec = parse_network_cfg(cfg)
    params = init_params(spec)
    if use_int8:
        from ..infer.quant import QuantizedThroughputEngine
        eng = QuantizedThroughputEngine(spec, params, batch=batch,
                                        presplit=use_presplit,
                                        quantize_head=use_qhead,
                                        phase_stem=use_phase,
                                        device=device)
    else:
        eng = ThroughputEngine(spec, params, batch=batch,
                               presplit=use_presplit, device=device)
    eng.warmup()
    r = eng.benchmark(iters=tics)
    sec = r["sec_per_batch"]
    print(f"Speed: {sec:f} sec/eval")
    print(f"Speed: {1.0/sec:f} Hz")
    if batch > 1:
        print(f"Speed: {r['images_per_sec']:.1f} images/sec (batch {batch})")


def cmd_ops(argv):
    """darknet.c:115-131: analytic FLOPs."""
    cfg = argv[0]
    from ..graph.spec import parse_network_cfg
    from ..infer.engine import analytic_flops
    spec = parse_network_cfg(cfg)
    ops = analytic_flops(spec)
    print(f"Floating Point Operations: {ops:.0f}")
    print(f"Floating Point Operations: {ops/1e9:.2f} Bn")


def cmd_partial(argv):
    cfg, weights, out, n = argv[0], argv[1], argv[2], int(argv[3])
    from ..io import surgery
    spec, params, _ = _load_net(cfg, weights)
    surgery.partial(spec, params, out, n)
    print(f"Saved first {n} layers to {out}")


def cmd_average(argv):
    cfg, out = argv[0], argv[1]
    from ..graph.spec import parse_network_cfg
    from ..io import surgery
    spec = parse_network_cfg(cfg)
    surgery.average(spec, argv[2:], out)
    print(f"Averaged {len(argv)-2} checkpoints -> {out}")


def _surgery_cmd(fn_name):
    def run(argv):
        cfg, weights, out = argv[0], argv[1], argv[2]
        from ..io import surgery
        from ..io.weights import save_weights
        spec, params, seen = _load_net(cfg, weights)
        fn = getattr(surgery, fn_name)
        res = fn(params, spec)
        if isinstance(res, tuple):
            params, spec = res
        else:
            params = res
        save_weights(spec, params, out, seen=seen)
        print(f"{fn_name} -> {out}")
    return run


def cmd_statistics(argv):
    cfg, weights = argv[0], argv[1]
    from ..io import surgery
    spec, params, _ = _load_net(cfg, weights)
    for row in surgery.statistics(params, spec):
        print(f"layer {row['layer']:3d} {row['kind']:<12} "
              f"shape={row['shape']} mean={row['mean']:+.4f} "
              f"std={row['std']:.4f}")


def cmd_visualize(argv):
    """Text rendering of the network graph (parser-table analog,
    parser.c:611 layer table)."""
    cfg = argv[0]
    from ..graph.spec import parse_network_cfg
    spec = parse_network_cfg(cfg)
    print("layer     type              input                output")
    for l in spec.layers:
        print(f"{l.index:5d} {l.kind:<16} {l.w:4d} x{l.h:4d} x{l.c:4d}"
              f"   ->  {l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}")
    from ..infer.engine import analytic_flops
    print(f"total FLOPs/forward: {analytic_flops(spec)/1e9:.2f} Bn")


def cmd_oneoff(argv):
    """oneoff (darknet.c:133-156): transfer shape-matching weights from
    one checkpoint into another architecture."""
    cfg_src, weights, cfg_dst, out = argv[0], argv[1], argv[2], argv[3]
    from ..graph.spec import parse_network_cfg
    from ..io import surgery
    from ..io.weights import load_weights, init_params, save_weights
    src_spec = parse_network_cfg(cfg_src)
    src_params, _ = load_weights(src_spec, weights)
    dst_spec = parse_network_cfg(cfg_dst)
    dst_params = init_params(dst_spec)
    merged, copied = surgery.transfer(src_params, src_spec, dst_spec,
                                      dst_params)
    save_weights(dst_spec, merged, out, seen=0)
    print(f"transferred {copied} layers -> {out}")


def cmd_detector(argv):
    """run_detector (detector.c:600-651): train / valid / recall / demo
    (apps/detector_app.py); `test` is `detect` on <cfg> <weights>
    <image>."""
    if argv[0] == "test":
        return cmd_detect(argv[2:3] + argv[3:])
    device = _device(argv)
    from .detector_app import run_detector
    return run_detector(argv, device=device)


def cmd_classifier(argv):
    """run_classifier (classifier.c:1124-1178): apps/classifier_app.py."""
    device = _device(argv)
    from .classifier_app import run_classifier
    return run_classifier(argv, device=device)


def cmd_cifar(argv):
    """cifar.c's run_cifar: apps/cifar_app.py."""
    device = _device(argv)
    from .cifar_app import run_cifar
    return run_cifar(argv, device=device)


def cmd_robot(argv):
    device = _device(argv)
    from .robot_app import run_robot
    return run_robot(argv, device=device)


def cmd_rnn(argv):
    device = _device(argv)
    from .rnn_app import run_char_rnn
    return run_char_rnn(argv, device=device)


def _cmd_yolo_v1(argv, *, coco: bool):
    """run_yolo (yolo.c:341-361) / run_coco (coco.c:368-389) /
    run_swag (swag.c:90): v1 train/test/valid/recall/demo."""
    device = _device(argv)
    sub = argv.pop(0)
    from .misc_apps import run_yolo_v1
    if sub == "train":
        data_cfg, cfg = argv[0], argv[1]
        weights = argv[2] if len(argv) > 2 and not argv[2].startswith("-") \
            else None
        return run_yolo_v1(data_cfg, cfg, weights, argv[3:], device=device)
    from . import yolo_v1_app as V1
    names = None
    if coco:
        from ..config import read_names
        nf = find_value(argv, "-names", None)
        names = read_names(nf) if nf else [str(i) for i in range(80)]
    cfg = argv.pop(0)
    if sub == "test":
        # two positionals after cfg = (weights, image); one = image
        pos = [a for a in argv[:2] if not a.startswith("-")]
        weights = argv.pop(0) if len(pos) == 2 else None
        return V1.test_yolo_v1(cfg, weights, argv.pop(0), argv,
                               names=names, device=device)
    weights = argv.pop(0) if argv and not argv[0].startswith("-") \
        else None
    if sub == "valid":
        return V1.validate_yolo_v1(cfg, weights, argv, names=names,
                                   coco=coco, device=device)
    if sub == "recall":
        return V1.validate_yolo_v1_recall(cfg, weights, argv, device=device)
    if sub == "demo":
        return V1.demo_yolo_v1(cfg, weights, argv, names=names,
                               device=device)
    raise SystemExit(f"yolo/coco: unknown subcommand {sub}")


def cmd_yolo(argv):
    return _cmd_yolo_v1(argv, coco=False)


def cmd_coco(argv):
    return _cmd_yolo_v1(argv, coco=True)


def cmd_nightmare(argv):
    device = _device(argv)
    from .nightmare_app import run_nightmare
    return run_nightmare(argv, device=device)


def _train_args(argv):
    """`<cfg> [weights] flags...` (after a subcommand such as `train`):
    (cfg, weights or None, the flags)."""
    w = argv[1] if len(argv) > 1 and not argv[1].startswith("-") else None
    return argv[0], w, argv[2:] if w else argv[1:]


def cmd_super(argv):
    device = _device(argv)
    if argv and argv[0] == "train":
        # train_super (super.c:10): SUPER_DATA random-crop pairs
        from .misc_train import train_super
        return train_super(*_train_args(argv[1:]), device=device)
    if argv and argv[0] == "test":
        argv = argv[1:]
    from .super_app import run_super
    return run_super(argv, device=device)


def cmd_go(argv):
    device = _device(argv)
    from .go_app import run_go
    return run_go(argv, device=device)


def cmd_gemm(argv):
    """gemm.c:232-341 time_ongpu analog: GFLOP/s of the library's
    matmul at darknet-shaped GEMMs. `gemm [m k n] [-reps N] [-f32]`
    (float32 with TF32 off; bf16 otherwise)."""
    import torch
    from ..utils.gemm_bench import run_gemm_bench
    device = _device(argv)
    reps = find_value(argv, "-reps", 200, int)
    dtype = torch.float32 if find_arg(argv, "-f32") else torch.bfloat16
    shapes = None
    if len(argv) >= 3:
        shapes = [(0, 0, int(argv[0]), int(argv[1]), int(argv[2]))]
    return run_gemm_bench(shapes, dtype=dtype, reps=reps, device=device)


def cmd_art(argv):
    device = _device(argv)
    from .misc_apps import art
    return art(argv[0], argv[1], argv[2], device=device)


def cmd_captcha(argv):
    device = _device(argv)
    if argv and argv[0] == "train":
        from .misc_train import train_captcha
        return train_captcha(*_train_args(argv[1:]), device=device)
    if argv and argv[0] == "test":
        # test_captcha (captcha.c:98): cfg [weights] <image> — two
        # positionals after cfg mean (weights, image), one means image
        from .misc_train import test_captcha
        rest = argv[1:]
        cfg = rest.pop(0)
        pos = [a for a in rest[:2] if not a.startswith("-")]
        w = rest.pop(0) if len(pos) == 2 else None
        return test_captcha(cfg, w, rest.pop(0), rest, device=device)
    if argv and argv[0] == "valid":
        from .misc_train import valid_captcha
        return valid_captcha(*_train_args(argv[1:]), device=device)
    from .misc_apps import captcha
    return captcha(argv[0], argv[1], argv[2], device=device)


def cmd_tag(argv):
    device = _device(argv)
    if argv and argv[0] == "train":
        from .misc_train import train_tag
        return train_tag(*_train_args(argv[1:]), device=device)
    from .misc_apps import tag
    from ..config import read_names
    names_file = find_value(argv, "-names", None)
    names = read_names(names_file) if names_file else None
    return tag(argv[0], argv[1], argv[2], names=names, device=device)


def cmd_compare(argv):
    device = _device(argv)
    if argv and argv[0] == "train":
        from .misc_train import train_compare
        return train_compare(*_train_args(argv[1:]), device=device)
    if argv and argv[0] in ("valid", "sort", "battle"):
        # run_compare dispatch (compare.c:343-359)
        from . import compare_app
        fn = {"valid": compare_app.validate_compare,
              "sort": compare_app.sort_master,
              "battle": compare_app.battle_royale}[argv[0]]
        return fn(*_train_args(argv[1:]), device=device)
    from .misc_apps import compare
    return compare(argv[0], argv[1], argv[2], argv[3], device=device)


def cmd_writing(argv):
    device = _device(argv)
    if argv and argv[0] == "train":
        from .misc_train import train_writing
        return train_writing(*_train_args(argv[1:]), device=device)
    from .misc_apps import writing
    out = find_value(argv, "-out", "writing_out.ppm")
    return writing(argv[0], argv[1], argv[2], out_path=out, device=device)


def cmd_3d(argv):
    _device(argv)                      # numpy on the host
    from .misc_apps import composite_3d
    delta = find_value(argv, "-delta", 0, int)
    out = argv[2] if len(argv) > 2 else "out.ppm"
    return composite_3d(argv[0], argv[1], out, delta=delta)


def cmd_imtest(argv):
    _device(argv)                      # numpy on the host
    from .misc_apps import imtest
    return imtest(argv[0], find_value(argv, "-out", "."))


def cmd_vid(argv):
    """rnn_vid: per-frame conv features -> feature-RNN demo; `vid
    train` / `vid generate` (rnn_vid.c:80, :154)."""
    device = _device(argv)
    if argv and argv[0] == "train":
        from .misc_train import train_vid_rnn
        return train_vid_rnn(*_train_args(argv[1:]), device=device)
    if argv and argv[0] == "generate":
        # generate_vid_rnn (rnn_vid.c:154-198)
        from .misc_apps import generate_vid_rnn
        return generate_vid_rnn(*_train_args(argv[1:]), device=device)
    import numpy as np
    from .misc_apps import VideoRNN
    from ..robot.frame_source import ImageDirectorySource
    cfg = argv[0]
    weights = argv[1] if len(argv) > 1 and not argv[1].startswith("-") \
        else None
    pattern = find_value(argv, "-frames", "frames/*.ppm")
    vr = VideoRNN(cfg, weights, device=device)
    src = ImageDirectorySource(pattern)
    frames = []
    for f in src:
        frames.append(f.color.astype(np.float32) / 255.0)
    feats = vr.features(np.stack(frames))
    print(f"extracted features: {feats.shape}")
    return feats


def cmd_dice(argv):
    """run_dice (dice.c:104-118): [train/test/valid] cfg [weights]
    [image]. A bare cfg (no subcommand) keeps the test behavior."""
    device = _device(argv)
    sub = argv[0]
    if sub in ("train", "valid", "test"):
        argv = argv[1:]
    else:
        sub = "test"
    cfg, weights, rest = _train_args(argv)
    if sub == "train":
        from .misc_train import train_dice
        return train_dice(cfg, weights, rest, device=device)
    if sub == "valid":
        from .misc_train import validate_dice
        return validate_dice(cfg, weights, rest, device=device)
    from .misc_apps import dice
    return dice(cfg, weights, argv[2], device=device)


def cmd_voxel(argv):
    device = _device(argv)
    if argv and argv[0] == "train":
        # train_voxel (voxel.c:51) == train_super over SUPER_DATA
        from .misc_train import train_voxel
        return train_voxel(*_train_args(argv[1:]), device=device)
    if argv and argv[0] == "extract":
        # extract_voxel (voxel.c:15): <left> <right> <prefix>
        from .misc_apps import extract_voxel
        return extract_voxel(argv[1], argv[2], argv[3], argv[4:])
    if argv and argv[0] == "test":
        argv = argv[1:]
    from .misc_apps import voxel
    out = find_value(argv, "-out", ".")
    return voxel(argv[0], argv[1], argv[2], out_dir=out, device=device)


COMMANDS = {
    "detect": cmd_detect,
    "detector": cmd_detector,
    "classify": cmd_classify,
    "classifier": cmd_classifier,
    "cifar": cmd_cifar,
    "robot": cmd_robot,
    "rnn": cmd_rnn,
    "nightmare": cmd_nightmare,
    "super": cmd_super,
    "go": cmd_go,
    "dice": cmd_dice,
    "voxel": cmd_voxel,
    "yolo": cmd_yolo,
    "coco": cmd_coco,
    "swag": cmd_yolo,
    "art": cmd_art,
    "captcha": cmd_captcha,
    "tag": cmd_tag,
    "compare": cmd_compare,
    "writing": cmd_writing,
    "speed": cmd_speed,
    "gemm": cmd_gemm,
    "ops": cmd_ops,
    "partial": cmd_partial,
    "average": cmd_average,
    "rescale": _surgery_cmd("rescale_net"),
    "reset": _surgery_cmd("reset_normalize_net"),
    "oneoff": cmd_oneoff,
    "3d": cmd_3d,
    "imtest": cmd_imtest,
    "test": cmd_imtest,
    "vid": cmd_vid,
    "rgbgr": _surgery_cmd("rgbgr_net"),
    "denormalize": _surgery_cmd("denormalize_net"),
    "normalize": _surgery_cmd("normalize_net"),
    "statistics": cmd_statistics,
    "visualize": cmd_visualize,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__, file=sys.stderr)
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
