"""darknet-compatible CLI: the `detect`, `speed`, `ops` and `detector`
subcommands.

Counterpart of ``sr_object_detection_tpu/apps/cli.py`` (cmd_detect,
cmd_speed, cmd_ops; src_yolo2/darknet.c:98-131,366-499 surface):

  python -m sr_object_detection_tpu_torch.apps.cli detect <cfg> <weights>
      <image> [-thresh T] [-names FILE] [-int8 [-qhead]] [-cpu]
  python -m sr_object_detection_tpu_torch.apps.cli speed <cfg> [tics]
      [-batch N] [-int8 [-phase-stem] [-qhead]] [-cpu]
  python -m sr_object_detection_tpu_torch.apps.cli ops <cfg>
  python -m sr_object_detection_tpu_torch.apps.cli detector train <data>
      <cfg> [weights] [-bf16] [-clear] [-resume ckpt] [-packed prefix]
      [-device-aug] [-decoder thread|process] [-cpu]

`detect`, `speed` and `detector` run on CUDA unless -cpu is given. The other
subcommands come with ROADMAP queue 1, item 9. Flag parsing follows the
reference's argv-splicing helpers (utils.c:62-118): '-key value' pairs
are plucked from anywhere.
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


def cmd_detect(argv):
    thresh = find_value(argv, "-thresh", 0.24, float)
    names_file = find_value(argv, "-names", None)
    use_int8 = find_arg(argv, "-int8")
    use_presplit = find_arg(argv, "-presplit")
    use_qhead = find_arg(argv, "-qhead")   # int8 head conv too
    use_cpu = find_arg(argv, "-cpu")
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
                   device="cpu" if use_cpu else "cuda")
    t0 = time.time()
    dets = det.detect(img, thresh=thresh)
    print(f"{image}: Predicted in {time.time()-t0:.6f} seconds.")
    for d in dets:
        label = d.name or str(d.class_id)
        print(f"{label}: {100*d.prob:.0f}%  box={d.box}")
    return dets


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
    use_cpu = find_arg(argv, "-cpu")
    batch = find_value(argv, "-batch", 1, int)
    cfg = argv[0]
    tics = int(argv[1]) if len(argv) > 1 else 20
    from ..graph.spec import parse_network_cfg
    from ..infer.engine import ThroughputEngine
    from ..io.weights import init_params
    spec = parse_network_cfg(cfg)
    params = init_params(spec)
    device = "cpu" if use_cpu else "cuda"
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


def cmd_detector(argv):
    """run_detector (detector.c:600-651): `train` (apps/detector_app.py)."""
    use_cpu = find_arg(argv, "-cpu")
    from .detector_app import run_detector
    return run_detector(argv, device="cpu" if use_cpu else "cuda")


COMMANDS = {"detect": cmd_detect, "speed": cmd_speed, "ops": cmd_ops,
            "detector": cmd_detector}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__, file=sys.stderr)
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
