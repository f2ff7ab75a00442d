"""Detection and classification input pipelines.

Counterpart of ``sr_object_detection_tpu/data/loader.py``'s detection
loader (the async analog of the reference's producer-thread loader,
src_yolo2/data.c:664-798): a pool decodes and augments the next batch
while the device trains on the current one. Images go through the port's
numpy helpers (``ops/image.py``) and the verbatim copy of
``data/augment.py``, so for the same seed the batches equal the JAX
loader's.

``device_augment=True``: the pool only decodes (uint8 frames and their
labels); the loader draws each image's parameters on the host and the
batch is augmented on the device (``data/device_aug.py``).
``decoder="process"``: the pool is spawned worker processes, so the
decode is not held by the interpreter lock; they run the module-level
``_decode_sample`` or ``load_detection_sample`` and never touch CUDA.
``process_index`` / ``process_count`` give this process's slice of the
image list (get_data_part, data.c:1128); they default to one process.

Truth layouts match the reference: detection (B, 30, 5) [x, y, w, h, id]
relative (data.c:295-332), label paths derived from image paths via the
find_replace chain (data.c:295-305); classification one-hot (B, classes),
the class found by substring match of its label in the path.
:class:`ClassificationLoader` takes the same draws as the JAX one (its
numpy sample function, ``load_cifar10_batch`` and ``fill_hierarchy`` are
verbatim copies); with ``device_augment`` its square crops go through
the same ``DeviceAugmenter`` gather as detection, on a canvas of the
batch's largest frame.

Not ported yet: reading the process coordinates from
``torch.distributed`` (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import pathlib
from typing import Iterator, Optional, Sequence

import numpy as np

from ..ops.image import (letterbox_image_np, load_image_rgb, load_image_u8,
                         resize_image_np)
from ..ops.layout import SECRET_NUM
from . import augment as A


def label_path_for(image_path: str) -> str:
    """data.c fill_truth_detection's find_replace chain."""
    p = image_path
    for a, b in (("images", "labels"), ("JPEGImages", "labels"),
                 ("raw", "labels")):
        p = p.replace(a, b, 1) if a in p else p
    root, _ = os.path.splitext(p)
    return root + ".txt"


def read_boxes(label_path: str) -> np.ndarray:
    """(N, 5) [id, x, y, w, h]; a missing file gives an empty array (the
    reference aborts; a loader skips instead)."""
    if not os.path.exists(label_path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(label_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                rows.append([float(v) for v in parts[:5]])
    if not rows:
        return np.zeros((0, 5), np.float32)
    return np.asarray(rows, np.float32)


def load_detection_sample(path: str, rng: np.random.Generator, *,
                          w: int, h: int, boxes: int, jitter: float,
                          hue: float, saturation: float, exposure: float,
                          augment: bool = True):
    """One (image, truth) pair with the reference's jitter-crop pipeline
    (load_data_detection, data.c:664-716)."""
    orig = load_image_rgb(path)
    oh, ow = orig.shape[:2]
    if augment:
        dw, dh = int(ow * jitter), int(oh * jitter)
        pleft = int(rng.uniform(-dw, dw))
        pright = int(rng.uniform(-dw, dw))
        ptop = int(rng.uniform(-dh, dh))
        pbot = int(rng.uniform(-dh, dh))
        swidth = ow - pleft - pright
        sheight = oh - ptop - pbot
        sx = swidth / ow
        sy = sheight / oh
        flip = bool(rng.integers(0, 2))
        cropped = A.crop_image(orig, pleft, ptop, swidth, sheight)
        dx = (pleft / ow) / sx
        dy = (ptop / oh) / sy
        sized = resize_image_np(cropped, w, h)
        if flip:
            sized = A.flip_horizontal(sized)
        sized = A.random_distort_image(sized, rng, hue, saturation,
                                       exposure)
    else:
        sized = resize_image_np(orig, w, h)
        dx = dy = 0.0
        sx = sy = 1.0
        flip = False

    labels = read_boxes(label_path_for(path))
    if len(labels):
        rng.shuffle(labels)         # randomize_boxes (data.c:161-170)
        labels = A.correct_boxes(labels, dx, dy, 1.0 / sx, 1.0 / sy, flip)
    truth = np.zeros((boxes, 5), np.float32)
    kept = 0
    for row in labels[:boxes]:
        cid, x, y, bw, bh = row
        if bw < 0.01 or bh < 0.01:   # data.c:322 skips slivers
            continue
        truth[kept] = [x, y, bw, bh, cid]
        kept += 1
    return sized, truth


def _decode_sample(p: str):
    """Decode one frame to uint8 and read its labels (module-level, so it
    pickles into the spawned decoder processes)."""
    return load_image_u8(p), read_boxes(label_path_for(p))


def shard(items, process_index: int, process_count: int):
    """get_data_part's row arithmetic (data.c:1128): process p of n owns
    items [N*p/n, N*(p+1)/n)."""
    if process_count <= 1:
        return items
    n = len(items)
    return items[n * process_index // process_count:
                 n * (process_index + 1) // process_count]


class DetectionLoader:
    """Prefetching detection batch loader (analog of load_data +
    load_threads double-buffering, data.c:717-798 + detector.c:86-113).

    With ``device_augment`` the batches are tensors on ``device`` in
    ``out_dtype`` (float32 by default; the trainer's compute dtype);
    otherwise numpy float32 arrays."""

    def __init__(self, list_file_or_paths, *, w: int, h: int,
                 batch: int, classes: int, boxes: int = 30,
                 jitter: float = 0.2, hue: float = 0.1,
                 saturation: float = 1.5, exposure: float = 1.5,
                 augment: bool = True, seed: int = 0, workers: int = 8,
                 device_augment: bool = False, decoder: str = "thread",
                 process_index: int = 0, process_count: int = 1,
                 device="cuda", out_dtype=None):
        if decoder not in ("thread", "process"):
            raise ValueError(f"decoder={decoder!r}: 'thread' or 'process'")
        if isinstance(list_file_or_paths, (str, pathlib.Path)):
            with open(list_file_or_paths) as f:
                self.paths = [l.strip() for l in f if l.strip()]
        else:
            self.paths = list(list_file_or_paths)
        self.paths = shard(self.paths, process_index, process_count)
        if not self.paths:
            raise ValueError("empty image list")
        self.w, self.h = w, h
        self.batch = batch
        self.boxes = boxes
        self.classes = classes
        self.aug = dict(jitter=jitter, hue=hue, saturation=saturation,
                        exposure=exposure, augment=augment)
        self.rng = np.random.default_rng(seed)
        if decoder == "process":
            # spawn, not fork: the parent has threads (and maybe CUDA),
            # and a forked child of such a process can deadlock
            import multiprocessing
            self.pool: cf.Executor = cf.ProcessPoolExecutor(
                max_workers=min(workers, os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn"))
        else:
            self.pool = cf.ThreadPoolExecutor(max_workers=workers)
        self.device_augment = device_augment
        self.device, self.out_dtype = device, out_dtype
        self._augmenters: dict = {}
        self._pending: Optional[list] = None
        self._submit()

    def set_dims(self, w: int, h: int):
        """Multi-scale resize hook (detector.c:91-109): batches submitted
        from now on load at the new resolution."""
        self.w, self.h = w, h

    def _submit(self):
        picks = [self.paths[self.rng.integers(0, len(self.paths))]
                 for _ in range(self.batch)]
        if self.device_augment:
            self._pending = [self.pool.submit(_decode_sample, p)
                             for p in picks]
            return
        seeds = self.rng.integers(0, 2**63, size=self.batch)
        w, h = self.w, self.h
        self._pending = [
            self.pool.submit(
                load_detection_sample, p, np.random.default_rng(int(s)),
                w=w, h=h, boxes=self.boxes, **self.aug)
            for p, s in zip(picks, seeds)]

    def next_batch(self):
        """Returns (x NHWC, truth (B,30,5)); prefetches the next."""
        results = [f.result() for f in self._pending]
        self._submit()
        if self.device_augment:
            return self._device_batch(results)
        x = np.stack([r[0] for r in results])
        t = np.stack([r[1] for r in results])
        return x, t

    def _device_batch(self, results):
        """The decoded frames' parameters drawn on the host (each image's
        draw, then its labels' shuffle, as the JAX loader draws them),
        the batch augmented on the device."""
        from . import device_aug as DA
        key = (self.w, self.h)
        if key not in self._augmenters:
            self._augmenters[key] = DA.DeviceAugmenter(
                self.w, self.h, device=self.device, out_dtype=self.out_dtype)
        aug = self._augmenters[key]
        params, truth = [], []
        for im, labels in results:
            p, xform = DA.draw_params(self.rng, *im.shape[:2], **self.aug)
            params.append(p)
            truth.append(DA.correct_truth(labels, self.rng, xform,
                                          self.boxes))
        canvas, cols = DA.stack_batch(aug, [r[0] for r in results], params)
        return aug(canvas, cols), np.stack(truth)

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> Iterator:
        while True:
            yield self.next_batch()




def load_classification_sample(path: str, rng: np.random.Generator, *,
                               w: int, h: int, min_crop: int,
                               max_crop: int, angle: float, aspect: float,
                               hue: float, saturation: float,
                               exposure: float, augment: bool = True):
    """load_data_augment's random_augment_image semantics
    (data.c:870-905, image.c random_augment_image): random square crop
    of side in [min_crop, max_crop] at random position, resized to
    (w, h), flip + HSV distort."""
    orig = load_image_rgb(path)
    oh, ow = orig.shape[:2]
    if augment:
        mn = min(ow, oh)
        lo = min(min_crop, mn)
        hi = min(max_crop, mn)
        side = int(rng.uniform(lo, max(hi, lo + 1)))
        dx = int(rng.uniform(0, max(ow - side, 1)))
        dy = int(rng.uniform(0, max(oh - side, 1)))
        crop = A.crop_image(orig, dx, dy, side, side)
        sized = resize_image_np(crop, w, h)
        if rng.integers(0, 2):
            sized = A.flip_horizontal(sized)
        sized = A.random_distort_image(sized, rng, hue, saturation,
                                       exposure)
    else:
        sized = letterbox_image_np(orig, w, h)
    return sized

class ClassificationLoader:
    """Labelled-by-path classification loader (data.c fill_truth: class
    id found by substring match of the label name in the path), the JAX
    package's, with the same draws from ``seed``.

    ``device_augment`` (with ``augment``): the pool only decodes uint8
    frames and the batch's square crops, flips and HSV distortions run on
    ``device`` (``data/device_aug.py``), the batch a tensor in
    ``out_dtype``; otherwise batches are numpy float32 arrays."""

    def __init__(self, list_file_or_paths, labels: Sequence[str], *,
                 w: int, h: int, batch: int,
                 min_crop: Optional[int] = None,
                 max_crop: Optional[int] = None,
                 angle: float = 0.0, aspect: float = 1.0,
                 hue: float = 0.0, saturation: float = 1.0,
                 exposure: float = 1.0, augment: bool = True,
                 seed: int = 0, workers: int = 8,
                 device_augment: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 device="cuda", out_dtype=None):
        if isinstance(list_file_or_paths, (str, pathlib.Path)):
            with open(list_file_or_paths) as f:
                self.paths = [l.strip() for l in f if l.strip()]
        else:
            self.paths = list(list_file_or_paths)
        self.paths = shard(self.paths, process_index, process_count)
        if not self.paths:
            raise ValueError("empty image list")
        self.labels = list(labels)
        self.w, self.h, self.batch = w, h, batch
        self.aug = dict(min_crop=min_crop or w, max_crop=max_crop or 2 * w,
                        angle=angle, aspect=aspect, hue=hue,
                        saturation=saturation, exposure=exposure,
                        augment=augment)
        self.rng = np.random.default_rng(seed)
        self.pool = cf.ThreadPoolExecutor(max_workers=workers)
        self.device_augment = device_augment and augment
        self.device, self.out_dtype = device, out_dtype
        self._augmenter = None
        self._pending = None
        self._submit()

    def class_of(self, path: str) -> int:
        for i, name in enumerate(self.labels):
            if name in path:
                return i
        return 0

    def _submit(self):
        picks = [self.paths[self.rng.integers(0, len(self.paths))]
                 for _ in range(self.batch)]
        self._picks = picks
        if self.device_augment:
            self._pending = [self.pool.submit(load_image_u8, p)
                             for p in picks]
            return
        seeds = self.rng.integers(0, 2**63, size=self.batch)
        self._pending = [
            self.pool.submit(load_classification_sample, p,
                             np.random.default_rng(int(s)),
                             w=self.w, h=self.h, **self.aug)
            for p, s in zip(picks, seeds)]

    def next_batch(self):
        """Returns (x NHWC, one-hot truth (B, classes)); prefetches the
        next."""
        imgs = [f.result() for f in self._pending]
        picks = self._picks
        self._submit()
        if self.device_augment:
            x = self._device_batch(imgs)
        else:
            x = np.stack(imgs)
        y = np.zeros((self.batch, len(self.labels)), np.float32)
        for i, p in enumerate(picks):
            y[i, self.class_of(p)] = 1.0
        return x, y

    def _device_batch(self, imgs):
        """random_augment_image (image.c) as per-image square-crop
        parameters, drawn on the host in the JAX loader's order, into the
        batched device augmentation."""
        from . import device_aug as DA
        if self._augmenter is None or (self._augmenter.w, self._augmenter.h
                                       ) != (self.w, self.h):
            self._augmenter = DA.DeviceAugmenter(
                self.w, self.h, device=self.device, out_dtype=self.out_dtype)
        aug, rng, a = self._augmenter, self.rng, self.aug
        params = []
        for im in imgs:
            oh, ow = im.shape[:2]
            mn = min(ow, oh)
            lo = min(a["min_crop"], mn)
            hi = min(a["max_crop"], mn)
            side = int(rng.uniform(lo, max(hi, lo + 1)))
            dx = int(rng.uniform(0, max(ow - side, 1)))
            dy = int(rng.uniform(0, max(oh - side, 1)))
            p = dict(oh=oh, ow=ow, pleft=dx, ptop=dy, swidth=side,
                     sheight=side, flip=bool(rng.integers(0, 2)),
                     dhue=float(rng.uniform(-a["hue"], a["hue"])),
                     dsat=float(A.rand_scale(rng, a["saturation"])),
                     dexp=float(A.rand_scale(rng, a["exposure"])))
            p["do_distort"] = not (p["dhue"] == 0 and p["dsat"] == 1
                                   and p["dexp"] == 1)
            params.append(p)
        return aug(*DA.stack_batch(aug, imgs, params))

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> Iterator:
        while True:
            yield self.next_batch()


def load_cifar10_batch(path: str):
    """CIFAR-10 binary batch reader (data.c:948-976): records of
    1 label byte + 3072 CHW pixel bytes; pixels /255."""
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    x = np.transpose(imgs, (0, 2, 3, 1)).copy()   # NHWC
    y = np.zeros((len(labels), 10), np.float32)
    y[np.arange(len(labels)), labels] = 1.0
    return x, y


def fill_hierarchy(truth: np.ndarray, tree) -> np.ndarray:
    """Hierarchical classification truth (data.c fill_hierarchy:401-431):
    set every ancestor of the labelled class(es) to 1, then mask every
    sibling group containing NO positive with SECRET_NUM so the masked
    SSE cost ignores those groups.

    truth: (C,) one-hot-ish float; tree: io.tree.WordTree."""
    t = truth.copy()
    parent = np.asarray(tree.parent)
    for j in np.nonzero(t > 0)[0]:
        p = parent[j]
        while p >= 0:
            t[p] = 1.0
            p = parent[p]
    offsets = np.asarray(tree.group_offset)
    sizes = np.asarray(tree.group_size)
    for off, size in zip(offsets, sizes):
        if size and not (t[off:off + size] > 0).any():
            t[off:off + size] = SECRET_NUM
    return t


__all__ = ["DetectionLoader", "ClassificationLoader", "load_detection_sample",
           "load_classification_sample", "load_cifar10_batch",
           "fill_hierarchy", "SECRET_NUM", "read_boxes", "label_path_for",
           "shard"]
