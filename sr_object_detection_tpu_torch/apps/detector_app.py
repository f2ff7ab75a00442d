"""Detector application: the train loop.

Counterpart of ``train_detector`` in
``sr_object_detection_tpu/apps/detector_app.py`` (run_detector,
src_yolo2/detector.c:25-168):

  detector train <data> <cfg> [weights] [-bf16] [-clear] [-resume ckpt]
      [-packed prefix] [-device-aug] [-decoder thread|process]

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
device come in the trainer's compute dtype. ``valid``/``recall``/
``demo`` come with ROADMAP queue 1, item 9.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import read_data_cfg
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
        trainer.state = ckpt.load_train_state(resume, trainer.state)

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
                    trainer.state)
    finally:
        loader.close()
    final = ckpt.checkpoint_name(backup_dir, base, 0, final=True)
    ckpt.export_weights(final, spec, trainer.state)
    return final


def run_detector(argv: list[str], *, device="cuda"):
    sub = argv.pop(0)
    if sub != "train":
        raise NotImplementedError(
            f"detector {sub} is not ported yet (ROADMAP queue 1, item 9)")
    data_cfg, cfg = argv[0], argv[1]
    weights = argv[2] if len(argv) > 2 and not argv[2].startswith("-") \
        else None
    rest = argv[3:] if weights else argv[2:]
    return train_detector(data_cfg, cfg, weights, rest, device=device)


__all__ = ["train_detector", "run_detector", "MULTI_SCALE_DIMS"]
