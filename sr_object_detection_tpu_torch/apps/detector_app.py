"""Detector application: train / valid / recall / demo.

Counterpart of ``sr_object_detection_tpu/apps/detector_app.py``
(run_detector, src_yolo2/detector.c:25-651):

  detector train <data> <cfg> [weights] [-bf16] [-clear] [-resume ckpt]
      [-packed prefix] [-device-aug] [-decoder thread|process]
  detector valid <data> <cfg> <weights> [-out prefix] [-outdir dir]
      [-thresh T] [-nms N] [-int8 [-qhead]]
  detector recall <data> <cfg> <weights> [-thresh T]
  detector demo <data> <cfg> <weights> [-frames glob | -video file |
      -cam index] [-names file] [-thresh T] [-outdir dir]

Every subcommand runs on ``device`` (CUDA unless the CLI's -cpu).

``-bf16`` is the production training mode: bf16 compute with the fused
leading pair (``kernels/phase_train.py``) where the layer fits. Training
resizes every 10 batches (from batch 1) to one of 320..608 when the
region layer has ``random=1``, and writes ``<base>_<N>.weights`` plus
``<base>.state.npz`` on the reference's cadence and
``<base>_final.weights`` at the end.

The input: ``-packed <prefix>`` trains from a packed record file
(``data/packed.py``: a memory-map gather, augmentation on the device);
otherwise the data cfg's image list is decoded, with ``-device-aug`` on
the device's batched augmentation (``data/device_aug.py``) and with
``-decoder process`` in spawned processes. Augmented batches on the
device come in the trainer's compute dtype. ``valid``, ``recall`` and
``demo`` are below.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..config import read_data_cfg, read_names
from ..graph.spec import RegionSpec, parse_network_cfg
from ..io import checkpoint as ckpt
from ..io.weights import load_weights
from .cli import find_arg, find_value

MULTI_SCALE_DIMS = [320 + 32 * i for i in range(10)]   # detector.c:95-99


def train_detector(data_cfg: str, cfg: str, weights: str | None,
                   argv: list[str], *, device="cuda"):
    """train_detector (detector.c:25-168): prefetching loader,
    multi-scale every 10 batches when region.random, checkpoints."""
    from ..data.loader import DetectionLoader
    from ..data.packed import PackedDetectionLoader
    from ..train.trainer import Trainer

    options = read_data_cfg(data_cfg)
    train_list = options.get("train", "data/train.list")
    backup_dir = options.get("backup", "backup")
    classes = int(options.get("classes", 20))
    os.makedirs(backup_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(cfg))[0]

    spec = parse_network_cfg(cfg)
    region = spec.layers[-1]
    if not isinstance(region, RegionSpec):
        raise ValueError(f"{cfg}: detector training needs a [region] head")
    params = None
    if weights:
        params, seen = load_weights(spec, weights)
    bf16 = find_arg(argv, "-bf16")
    dtype = torch.bfloat16 if bf16 else None
    trainer = Trainer(spec, params=params, device=device,
                      compute_dtype=dtype, phase_train=bf16)
    clear = find_arg(argv, "-clear")
    if weights and not clear:
        trainer.state.seen = torch.tensor(int(seen), dtype=torch.int64)
    resume = find_value(argv, "-resume", None)
    if resume:
        trainer.state = ckpt.load_train_state(resume, trainer.state, spec)

    max_batches = spec.net.max_batches or 10000
    outer = trainer.outer_batch
    device_aug = find_arg(argv, "-device-aug")
    packed = find_value(argv, "-packed", None)
    decoder = find_value(argv, "-decoder", "thread")
    aug = dict(w=spec.net.w, h=spec.net.h, batch=outer, jitter=region.jitter,
               hue=spec.net.hue, saturation=spec.net.saturation,
               exposure=spec.net.exposure)
    if packed:
        loader = PackedDetectionLoader(packed, device=device,
                                       out_dtype=dtype, **aug)
    else:
        loader = DetectionLoader(
            train_list, classes=classes, device_augment=device_aug,
            decoder=decoder, device=device, out_dtype=dtype, **aug)
    avg_loss = None
    rng = np.random.default_rng(7)
    try:
        while True:
            i = int(trainer.state.seen) // outer + 1
            if i > max_batches:
                break
            # multi-scale resize every 10 batches (detector.c:91-109)
            if region.random and i % 10 == 1:
                d = int(rng.choice(MULTI_SCALE_DIMS))
                loader.set_dims(d, d)
                print(f"Resizing: {d}x{d}")
            t0 = time.time()
            x, truth = loader.next_batch()
            load_t = time.time() - t0
            t0 = time.time()
            m = trainer.step(x, truth)
            loss = float(m["loss"]) / outer
            avg_loss = loss if avg_loss is None else \
                avg_loss * 0.9 + loss * 0.1
            print(f"{i}: {loss:.6f}, {avg_loss:.6f} avg, "
                  f"{float(m['lr']):.6f} rate, {time.time()-t0:.3f} s, "
                  f"{load_t:.3f} load, {int(trainer.state.seen)} images")
            if ckpt.should_checkpoint(i):
                ckpt.export_weights(ckpt.checkpoint_name(backup_dir, base, i),
                                    spec, trainer.state)
                ckpt.save_train_state(
                    os.path.join(backup_dir, f"{base}.state.npz"),
                    trainer.state, spec)
    finally:
        loader.close()
    final = ckpt.checkpoint_name(backup_dir, base, 0, final=True)
    ckpt.export_weights(final, spec, trainer.state)
    return final


def validate_detector(data_cfg: str, cfg: str, weights: str,
                      argv: list[str], *, device="cuda"):
    """validate_detector (detector.c:244-369): run the valid list, write
    per-class VOC detection files (comp4_det_test_<cls>.txt)."""
    from ..eval.voc import voc_det_lines
    from ..infer.detector import Detector
    from ..kernels import nms as NMS
    from ..ops.image import load_image_rgb

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/valid.list")
    names = read_names(options["names"]) if "names" in options else None
    prefix = find_value(argv, "-out", "comp4_det_test_")
    outdir = find_value(argv, "-outdir", "results")
    os.makedirs(outdir, exist_ok=True)
    thresh = find_value(argv, "-thresh", 0.005, float)
    nms = find_value(argv, "-nms", 0.45, float)
    use_int8 = find_arg(argv, "-int8")
    use_qhead = find_arg(argv, "-qhead")   # int8 head conv too

    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    calib = None
    if use_int8:
        # int8 serving validation: calibrate activation scales on the
        # first few validation images; v2 valid uses plain resize, not
        # letterbox (detector.c:483)
        from ..ops.image import resize_image_np
        net = parse_network_cfg(cfg).net
        calib = np.stack([
            resize_image_np(load_image_rgb(p), net.w, net.h)
            for p in paths[:8]])
    det = Detector(cfg, weights, names=names, int8_calib=calib,
                   quantize_head=use_qhead, device=device)
    if names is None:
        names = [str(i) for i in range(det.region.classes)]
    files = {n: open(os.path.join(outdir, f"{prefix}{n}.txt"), "w")
             for n in names}
    t0 = time.time()
    try:
        for k, path in enumerate(paths):
            img = load_image_rgb(path)
            ih, iw = img.shape[:2]
            image_id = os.path.splitext(os.path.basename(path))[0]
            boxes, probs = det.predict_batch(det.preprocess(img)[None],
                                             thresh=thresh)
            boxes, probs = boxes[0], probs[0]
            if nms > 0:
                # exact NMS (k = N): valid is scored on the whole
                # low-confidence tail (thresh .005), which a top-k cut
                # would drop
                probs = NMS.nms_sort_topk(boxes, probs, nms,
                                          k=boxes.shape[0])
            for name, lines in voc_det_lines(
                    image_id, boxes.cpu().numpy(), probs.cpu().numpy(),
                    names, iw, ih).items():
                for line in lines:
                    files[name].write(line + "\n")
            if (k + 1) % 100 == 0:
                print(f"{k+1}/{len(paths)}", file=sys.stderr)
    finally:
        for f in files.values():
            f.close()
    print(f"Total Detection Time: {time.time()-t0:.6f} Seconds")


def validate_recall(data_cfg: str, cfg: str, weights: str,
                    argv: list[str], *, device="cuda"):
    """validate_detector_recall (detector.c:371-450)."""
    from ..data.loader import label_path_for, read_boxes
    from ..eval.voc import proposal_recall
    from ..infer.detector import Detector
    from ..ops.image import load_image_rgb

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/valid.list")
    thresh = find_value(argv, "-thresh", 0.24, float)
    det = Detector(cfg, weights, device=device)
    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    all_boxes, all_obj, all_gt = [], [], []
    for path in paths:
        img = load_image_rgb(path)
        boxes, probs = det.predict_batch(det.preprocess(img)[None])
        all_boxes.append(boxes[0].cpu().numpy())
        all_obj.append(probs[0].cpu().numpy().max(axis=1))
        labels = read_boxes(label_path_for(path))
        all_gt.append(labels[:, 1:5] if len(labels) else
                      np.zeros((0, 4), np.float32))
    r = proposal_recall(all_boxes, all_obj, all_gt, thresh=thresh)
    print(f"RPs/Img: {r['proposals']/max(len(paths),1):.2f}  "
          f"IOU: {100*r['avg_iou']:.2f}%  "
          f"Recall: {100*r['recall']:.2f}%")
    return r


def demo_detector(cfg: str, weights: str, argv: list[str], *,
                  device="cuda"):
    """detector demo (demo.c:118-252): fetch/detect overlap + 3-frame
    smoothing over an image-directory source (-frames), a video file
    (-video: PIL multi-frame containers in-process, anything else via
    an ffmpeg rawvideo pipe) or a live camera (-cam <index>, an ffmpeg
    v4l2 pipe)."""
    from ..infer.detector import Detector
    from ..robot.frame_source import (ImageDirectorySource,
                                      V4L2FrameSource, VideoFileSource)
    from .demo_app import StreamingDemo
    video = find_value(argv, "-video", None)
    cam = find_value(argv, "-cam", None)
    pattern = find_value(argv, "-frames", "frames/*.ppm")
    names_file = find_value(argv, "-names", None)
    names = read_names(names_file) if names_file else None
    thresh = find_value(argv, "-thresh", 0.24, float)
    out_dir = find_value(argv, "-outdir", None)
    det = Detector(cfg, weights, names=names, device=device)
    source = (V4L2FrameSource(f"/dev/video{int(cam)}") if cam is not None
              else VideoFileSource(video) if video
              else ImageDirectorySource(pattern))
    demo = StreamingDemo(det, source, thresh=thresh, out_dir=out_dir)

    def show(r):
        labels = ", ".join(f"{d.name or d.class_id}:{d.prob:.2f}"
                           for d in r["detections"])
        print(f"FPS:{r['fps']:.1f}  {labels}")

    return demo.run(on_result=show)


def run_detector(argv: list[str], *, device="cuda"):
    """run_detector (detector.c:600-651). ``detector test`` is the CLI's
    ``detect`` (apps/cli.py)."""
    sub = argv.pop(0)
    if sub == "demo":
        return demo_detector(argv[1], argv[2], argv[3:], device=device)
    data_cfg, cfg = argv[0], argv[1]
    weights = argv[2] if len(argv) > 2 and not argv[2].startswith("-") \
        else None
    rest = argv[3:] if weights else argv[2:]
    if sub == "train":
        return train_detector(data_cfg, cfg, weights, rest, device=device)
    if sub == "valid":
        return validate_detector(data_cfg, cfg, weights, rest, device=device)
    if sub == "recall":
        return validate_recall(data_cfg, cfg, weights, rest, device=device)
    raise SystemExit(f"unknown detector subcommand {sub}")


__all__ = ["train_detector", "validate_detector", "validate_recall",
           "demo_detector", "run_detector", "MULTI_SCALE_DIMS"]
