"""Packed raw-u8 dataset: the from-disk training format.

Counterpart of ``sr_object_detection_tpu/data/packed.py``. The reference
trains from JPEG files decoded on loader pthreads
(src_yolo2/data.c:717-798); decoding every image every epoch holds the
host far below the training step's rate. The reference's CIFAR path
(data.c:948 load_cifar10_data) reads raw fixed-size records instead;
this module is that idea at detection scale:

  * ``pack_detection_dataset``: one-time preparation, the decode paid
    once. Each image is decoded, resized to a fixed storage resolution
    with the darknet two-pass bilinear (ops/image.py), rounded to u8 and
    stored as flat NHWC records, with an (N, boxes, 5) float32 label
    tensor and a JSON header. The files are byte-equal to the JAX
    package's.
  * ``PackedDetectionLoader``: the training-time reader. It memory-maps
    the records, gathers a random batch (a copy, no decode), draws the
    same per-image augmentation parameters as the file-list loader, and
    feeds the batched device augmentation (data/device_aug.py). Labels
    are relative, so packing leaves them as they are; the crop and flip
    correct them per batch.

Choose a storage resolution at or above the largest training resolution
(448, or 608 for multi-scale to 608): the jitter crop then takes the
stored frame as the "original".

Record layout (prefix.imgs): N * SH * SW * 3 bytes, row-major u8 RGB.
Labels (prefix.labs): N * boxes * 5 float32 [cls, cx, cy, w, h] relative.
Header (prefix.json): {"n", "h", "w", "c", "boxes", "version"}.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import pathlib
from typing import Iterator

import numpy as np

from . import device_aug as DA
from .loader import label_path_for, read_boxes, shard

_VERSION = 1


def pack_detection_dataset(list_file_or_paths, out_prefix: str, *,
                           store_w: int = 448, store_h: int = 448,
                           boxes: int = 30, workers: int = 8,
                           quiet: bool = False) -> dict:
    """One-time preparation: decode and resize every image into the
    packed record file. Returns the header dict."""
    from ..ops.image import load_image_u8, resize_image_np

    if isinstance(list_file_or_paths, (str, pathlib.Path)):
        with open(list_file_or_paths) as f:
            paths = [l.strip() for l in f if l.strip()]
    else:
        paths = list(list_file_or_paths)
    if not paths:
        raise ValueError("empty image list")

    n = len(paths)
    hdr = {"n": n, "h": store_h, "w": store_w, "c": 3, "boxes": boxes,
           "version": _VERSION}
    labs = np.zeros((n, boxes, 5), np.float32)

    def _one(path):
        im = load_image_u8(path)
        if im.shape[:2] != (store_h, store_w):
            # the darknet resize in the u8 value domain, rounded back to
            # u8 (at most 0.5/255 a pixel, paid once)
            im = np.clip(resize_image_np(im.astype(np.float32),
                                         store_w, store_h) + 0.5,
                         0, 255).astype(np.uint8)
        return im, read_boxes(label_path_for(path))

    with open(out_prefix + ".imgs", "wb") as f, \
            cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for i, (im, lab) in enumerate(pool.map(_one, paths)):
            if im.shape != (store_h, store_w, 3) or im.dtype != np.uint8:
                raise ValueError(f"{paths[i]}: record {im.shape} "
                                 f"{im.dtype}")
            f.write(im.tobytes())
            lab = lab[:boxes]
            labs[i, :len(lab)] = lab       # [cls, cx, cy, w, h] relative
            if not quiet and (i + 1) % 500 == 0:
                print(f"packed {i + 1}/{n}")
    labs.tofile(out_prefix + ".labs")
    with open(out_prefix + ".json", "w") as f:
        json.dump(hdr, f)
    return hdr


class PackedDetectionLoader:
    """Training-time reader over a packed dataset: a gather from the
    memory map, the parameters drawn on the host, the augmentation on
    ``device`` (always: that is the point). Same ``next_batch`` /
    ``set_dims`` / iteration contract as ``DetectionLoader``; the batch
    is a tensor on ``device`` in ``out_dtype`` (float32 by default; the
    trainer passes its compute dtype).

    Process p of n reads records [N*p/n, N*(p+1)/n) (get_data_part,
    src_yolo2/data.c:1128). One prefetch thread builds the next batch,
    its device work included, while the caller trains on this one (the
    reference's load_thread double buffer, detector.c:86-113)."""

    def __init__(self, prefix: str, *, w: int, h: int, batch: int,
                 jitter: float = 0.2, hue: float = 0.1,
                 saturation: float = 1.5, exposure: float = 1.5,
                 augment: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 device="cuda", out_dtype=None):
        with open(prefix + ".json") as f:
            self.hdr = json.load(f)
        n, sh, sw = self.hdr["n"], self.hdr["h"], self.hdr["w"]
        self.boxes = self.hdr["boxes"]
        self.imgs = np.memmap(prefix + ".imgs", dtype=np.uint8,
                              mode="r", shape=(n, sh, sw, 3))
        self.labs = np.memmap(prefix + ".labs", dtype=np.float32,
                              mode="r", shape=(n, self.boxes, 5))
        idx = shard(range(n), process_index, process_count)
        self.lo, self.hi = (idx[0], idx[-1] + 1) if len(idx) else (0, 0)
        if self.hi <= self.lo:
            raise ValueError("empty shard")
        self.w, self.h, self.batch = w, h, batch
        self.device, self.out_dtype = device, out_dtype
        self.aug = dict(jitter=jitter, hue=hue, saturation=saturation,
                        exposure=exposure, augment=augment)
        self.rng = np.random.default_rng(seed)
        self._augmenters: dict = {}
        self.pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending = self.pool.submit(self._host_batch)

    def set_dims(self, w: int, h: int):
        """Multi-scale hook (detector.c:91-109)."""
        self.w, self.h = w, h

    def _augmenter(self, w: int, h: int):
        key = (w, h)
        if key not in self._augmenters:
            self._augmenters[key] = DA.DeviceAugmenter(
                w, h, device=self.device, out_dtype=self.out_dtype)
        return self._augmenters[key]

    def _host_batch_cpu(self):
        """The host side of one batch, no device work: the record gather
        (a copy out of the page cache), the parameter draw and the label
        correction. Returns (augmenter, canvas, columns, truth, dims)."""
        # the dims are read once: set_dims may fire from the main thread
        # meanwhile, and next_batch checks them against the batch's
        w, h = self.w, self.h
        aug = self._augmenter(w, h)
        sh, sw = self.hdr["h"], self.hdr["w"]
        idx = self.rng.integers(self.lo, self.hi, size=self.batch)
        canvas = np.ascontiguousarray(self.imgs[idx])
        truth = np.zeros((self.batch, self.boxes, 5), np.float32)
        params = []
        for b, i in enumerate(idx):
            p, xform = DA.draw_params(self.rng, sh, sw, **self.aug)
            params.append(p)
            labels = np.asarray(self.labs[i])
            labels = labels[labels[:, 3] > 0]        # stored padding
            truth[b] = DA.correct_truth(labels, self.rng, xform, self.boxes)
        return aug, canvas, aug.columns(params), truth, (w, h)

    def _host_batch(self):
        """One batch from the prefetch thread: the host side, then the
        upload and the augmentation launched on the device, so the copy
        overlaps the caller's step."""
        aug, canvas, cols, truth, dims = self._host_batch_cpu()
        return aug(canvas, cols), truth, dims

    def next_batch(self):
        """(x NHWC on the device, truth (B, boxes, 5)); prefetches."""
        x, truth, dims = self._pending.result()
        if dims != (self.w, self.h):     # resized meanwhile: redraw
            # before the next prefetch starts, so that the two never draw
            # from the generator at once (the JAX loader lets them race)
            x, truth, _ = self._host_batch()
        self._pending = self.pool.submit(self._host_batch)
        return x, truth

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> Iterator:
        while True:
            yield self.next_batch()


__all__ = ["pack_detection_dataset", "PackedDetectionLoader"]
