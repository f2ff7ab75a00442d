"""darknet-compatible CLI, the `detect` subcommand.

Counterpart of ``sr_object_detection_tpu/apps/cli.py`` (cmd_detect,
src_yolo2/darknet.c:366-499 surface):

  python -m sr_object_detection_tpu_torch.apps.cli detect <cfg> <weights>
      <image> [-thresh T] [-names FILE] [-cpu]

It runs on CUDA unless -cpu is given. The other subcommands come with
ROADMAP queue 1, item 9. Flag parsing follows the reference's
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


def cmd_detect(argv):
    thresh = find_value(argv, "-thresh", 0.24, float)
    names_file = find_value(argv, "-names", None)
    use_cpu = find_arg(argv, "-cpu")
    cfg, weights, image = argv[0], argv[1], argv[2]
    from ..config import read_names
    from ..infer.detector import Detector
    from ..ops.image import load_image_rgb
    names = read_names(names_file) if names_file else None
    img = load_image_rgb(image)
    det = Detector(cfg, weights, names=names,
                   device="cpu" if use_cpu else "cuda")
    t0 = time.time()
    dets = det.detect(img, thresh=thresh)
    print(f"{image}: Predicted in {time.time()-t0:.6f} seconds.")
    for d in dets:
        label = d.name or str(d.class_id)
        print(f"{label}: {100*d.prob:.0f}%  box={d.box}")
    return dets


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "detect":
        print(__doc__, file=sys.stderr)
        return 1
    cmd_detect(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
