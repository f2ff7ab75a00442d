"""Binary inference worker for the native C++ detection API.

Counterpart of ``sr_object_detection_tpu/infer/serve.py``; it speaks the
same sr_detector pipe protocol (native/src/detector_api.cpp), byte for
byte:

  handshake (worker -> host):  int32 magic 0x53524456, net_w, net_h,
                               n_boxes, classes
  request  (host -> worker):   int32 w, h, c (w<=0 -> exit), float32
                               thresh, then w*h*c float32 HWC RGB [0,1]
  response (worker -> host):   n_boxes*4 float32 decoded boxes
                               (cx,cy,w,h relative) then
                               n_boxes*classes float32 probs with
                               get_region_boxes' thresh gating applied

Usage: python -m sr_object_detection_tpu_torch.infer.serve <cfg> <weights>
       [--cpu] [--int8]

The worker runs on CUDA unless --cpu is given; with no CUDA device and
no --cpu it exits with status 2. --int8 serves the quantized program
(infer/quant.py), calibrating the activation scales on the FIRST frame
the client sends — send a representative frame first.
"""

from __future__ import annotations

import struct
import sys

MAGIC = 0x53524456


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    use_cpu = "--cpu" in argv
    if use_cpu:
        argv.remove("--cpu")
    use_int8 = "--int8" in argv
    if use_int8:
        argv.remove("--int8")
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    cfg_path, weights_path = argv[0], argv[1]

    import numpy as np
    import torch

    if not use_cpu and not torch.cuda.is_available():
        print("serve: no CUDA device (pass --cpu to serve on the CPU)",
              file=sys.stderr)
        return 2
    from .detector import Detector

    det = Detector(cfg_path, weights_path,
                   device="cpu" if use_cpu else "cuda")
    r = det.region
    n_boxes = r.h * r.w * r.n

    out = sys.stdout.buffer
    inp = sys.stdin.buffer
    out.write(struct.pack("<5i", MAGIC, det.spec.net.w, det.spec.net.h,
                          n_boxes, r.classes))
    out.flush()

    while True:
        hdr = inp.read(16)
        if len(hdr) < 16:
            return 0
        w, h, c, thresh = struct.unpack("<3if", hdr)
        if w <= 0:
            return 0
        if h <= 0 or c <= 0 or w * h * c > 1 << 28:
            print(f"serve: bad request header w={w} h={h} c={c}",
                  file=sys.stderr)
            return 1
        n = w * h * c
        buf = inp.read(4 * n)
        if len(buf) < 4 * n:
            return 0
        img = np.frombuffer(buf, "<f4").reshape(h, w, c)
        x = det.preprocess(img)[None]
        if use_int8:
            # quantize in place on first use, calibrated on this first
            # real frame
            det.quantize(x)
            use_int8 = False
        boxes, probs = det.predict_batch(x, thresh=thresh)
        out.write(np.asarray(boxes[0].cpu(), "<f4").tobytes())
        out.write(np.asarray(probs[0].cpu(), "<f4").tobytes())
        out.flush()


if __name__ == "__main__":
    sys.exit(main())
