"""Batched detection augmentation on the device.

Counterpart of ``sr_object_detection_tpu/data/device_aug.py``. The
reference augments per image on the host (load_data_detection,
src_yolo2/data.c:664-716: jitter crop -> stretch resize -> flip -> HSV
distort), which in numpy runs at tens of images a second a core. Here
the host only decodes frames and draws each image's parameters; the
batch then goes through one pass of torch ops on the device: the
edge-clamped crop composed with darknet's two-pass bilinear as four
gathered taps (the horizontal mix first, then the vertical one, the
float order of ``ops.image.resize_image_np``), the horizontal flip, and
the HSV distortion (image.c:1718-1795's sextant math).

Frames of different sizes sit in a zero-padded uint8 canvas (B, Hmax,
Wmax, 3), each with its real size in its parameters; the taps never
read the padding. The tap indices and weights are computed on the host
in numpy (``host_coeffs``), so they equal the host pipeline's exactly.

This is the JAX package's gather form (``resample="gather"``). Its
``resample="matmul"`` and ``precision="fast"`` (one-hot matmuls on the
TPU's matrix unit) and its canvas buckets (which bounded XLA
recompiles) are not ported (ROADMAP "Not ported").
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.image import _resize_coeffs
from .augment import rand_scale


def host_coeffs(in_size: int, out_size: int, *, clamp_last: bool,
                off: int, limit: int):
    """Darknet resize coefficients in the exact numpy float32 math of
    ``ops.image._resize_coeffs``, composed with the edge-clamped crop
    (source index = clip(off + i, 0, limit - 1)): (s0, s1, w0, w1)."""
    i0, i1, w0, w1 = _resize_coeffs(in_size, out_size,
                                    clamp_last=clamp_last)
    s0 = np.clip(off + i0, 0, limit - 1).astype(np.int32)
    s1 = np.clip(off + i1, 0, limit - 1).astype(np.int32)
    return s0, s1, w0.astype(np.float32), w1.astype(np.float32)


def _rgb_to_hsv(r, g, b):
    """image.c:1718-1753 (h in [0, 1))."""
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn
    s = torch.where(mx == 0, 0.0, delta / torch.where(mx == 0, 1.0, mx))
    dsafe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(r == mx, (g - b) / dsafe,
                    torch.where(g == mx, 2.0 + (b - r) / dsafe,
                                4.0 + (r - g) / dsafe))
    h = torch.where(delta == 0, 0.0, h)
    h = torch.where(h < 0, h + 6.0, h) / 6.0
    h = torch.where(mx == 0, 0.0, h)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    """image.c:1755-1795's sextant table."""
    h6 = h * 6.0
    fl = torch.floor(h6)
    idx = fl.to(torch.int32) % 6
    f = h6 - fl
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))

    def pick(table):
        out = table[0]
        for k in range(1, 6):
            out = torch.where(idx == k, table[k], out)
        return out
    gray = s == 0
    return torch.stack([torch.where(gray, v, pick([v, q, p, p, t, v])),
                        torch.where(gray, v, pick([t, v, v, q, p, p])),
                        torch.where(gray, v, pick([p, p, t, v, v, q]))],
                       dim=-1)


def augment_batch(canvas, p, *, out_dtype=None):
    """The batch's augmentation: ``canvas`` (B, Hmax, Wmax, 3) uint8 and
    the per-image tables ``p`` (tensors on canvas' device: sx0, sx1
    (B, w) int64, wx0, wx1 (B, w) float32, sy0, sy1, wy0, wy1 (B, h),
    flip and do_distort (B,) bool, dhue, dsat, dexp (B,) float32) ->
    (B, h, w, 3) in [0, 1], float32 or ``out_dtype``."""
    bsz = canvas.shape[0]
    bi = torch.arange(bsz, device=canvas.device)[:, None, None]
    sy0, sy1 = p["sy0"][:, :, None], p["sy1"][:, :, None]
    sx0, sx1 = p["sx0"][:, None, :], p["sx1"][:, None, :]
    wx0, wx1 = p["wx0"][:, None, :, None], p["wx1"][:, None, :, None]
    # a tensor divisor: a Python scalar would let the CUDA kernel multiply
    # by its reciprocal, one bit off the host pipeline's division
    k255 = torch.full((), 255.0, device=canvas.device)

    def tap(rows, cols):
        return canvas[bi, rows, cols].float() / k255    # (B, h, w, 3)
    part0 = wx0 * tap(sy0, sx0) + wx1 * tap(sy0, sx1)
    part1 = wx0 * tap(sy1, sx0) + wx1 * tap(sy1, sx1)
    out = (p["wy0"][:, :, None, None] * part0
           + p["wy1"][:, :, None, None] * part1)
    del part0, part1
    out = torch.where(p["flip"][:, None, None, None], out.flip(2), out)
    hh, ss, vv = _rgb_to_hsv(out[..., 0], out[..., 1], out[..., 2])
    ss = ss * p["dsat"][:, None, None]
    vv = vv * p["dexp"][:, None, None]
    hh = hh + p["dhue"][:, None, None]
    hh = torch.where(hh > 1.0, hh - 1.0, hh)
    hh = torch.where(hh < 0.0, hh + 1.0, hh)
    dist = _hsv_to_rgb(hh, ss, vv).clamp_(0.0, 1.0)
    out = torch.where(p["do_distort"][:, None, None, None], dist, out)
    return out if out_dtype is None else out.to(out_dtype)


class DeviceAugmenter:
    """Batched augmentation to (h, w) on ``device``: call with a padded
    uint8 canvas and the per-image columns of :meth:`coeffs` stacked over
    the batch. The output is float32, or ``out_dtype`` (the trainer's
    compute dtype)."""

    _KEYS = ("sx0", "sx1", "wx0", "wx1", "sy0", "sy1", "wy0", "wy1",
             "flip", "dhue", "dsat", "dexp", "do_distort")

    def __init__(self, w: int, h: int, *, device="cuda", out_dtype=None):
        self.w, self.h = w, h
        self.device = torch.device(device)
        self.out_dtype = out_dtype

    def coeffs(self, params: dict) -> dict:
        """Host-side tap tables for one image's crop params."""
        sx0, sx1, wx0, wx1 = host_coeffs(
            params["swidth"], self.w, clamp_last=True,
            off=params["pleft"], limit=params["ow"])
        sy0, sy1, wy0, wy1 = host_coeffs(
            params["sheight"], self.h, clamp_last=False,
            off=params["ptop"], limit=params["oh"])
        return dict(sx0=sx0, sx1=sx1, wx0=wx0, wx1=wx1, sy0=sy0,
                    sy1=sy1, wy0=wy0, wy1=wy1, flip=params["flip"],
                    dhue=np.float32(params["dhue"]),
                    dsat=np.float32(params["dsat"]),
                    dexp=np.float32(params["dexp"]),
                    do_distort=params["do_distort"])

    def columns(self, params) -> dict:
        """The :meth:`coeffs` of a batch's per-image params, stacked."""
        coefs = [self.coeffs(p) for p in params]
        return {k: np.stack([c[k] for c in coefs]) for k in coefs[0]}

    def upload(self, canvas_u8, params: dict):
        """The canvas and the columns as tensors on the device (indices
        int64)."""
        dev = self.device
        cols = {}
        for k in self._KEYS:
            a = np.asarray(params[k])
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            cols[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return torch.as_tensor(canvas_u8).to(dev), cols

    def __call__(self, canvas_u8, params: dict):
        canvas, cols = self.upload(canvas_u8, params)
        return augment_batch(canvas, cols, out_dtype=self.out_dtype)


def draw_params(rng: np.random.Generator, oh: int, ow: int, *,
                jitter: float, hue: float, saturation: float,
                exposure: float, augment: bool = True):
    """The host-side RNG draws — the same distributions as the host
    pipeline (load_detection_sample / rand_scale)."""
    if not augment:
        return dict(oh=oh, ow=ow, pleft=0, ptop=0, swidth=ow,
                    sheight=oh, flip=False, dhue=0.0, dsat=1.0,
                    dexp=1.0, do_distort=False), (0.0, 0.0, 1.0, 1.0,
                                                  False)
    dw, dh = int(ow * jitter), int(oh * jitter)
    pleft = int(rng.uniform(-dw, dw))
    pright = int(rng.uniform(-dw, dw))
    ptop = int(rng.uniform(-dh, dh))
    pbot = int(rng.uniform(-dh, dh))
    swidth = ow - pleft - pright
    sheight = oh - ptop - pbot
    sx, sy = swidth / ow, sheight / oh
    flip = bool(rng.integers(0, 2))
    dhue = float(rng.uniform(-hue, hue))
    dsat = float(rand_scale(rng, saturation))
    dexp = float(rand_scale(rng, exposure))
    do_distort = not (dhue == 0 and dsat == 1 and dexp == 1)
    params = dict(oh=oh, ow=ow, pleft=pleft, ptop=ptop, swidth=swidth,
                  sheight=sheight, flip=flip, dhue=dhue, dsat=dsat,
                  dexp=dexp, do_distort=do_distort)
    box_xform = ((pleft / ow) / sx, (ptop / oh) / sy, 1.0 / sx,
                 1.0 / sy, flip)
    return params, box_xform


def correct_truth(labels, rng, box_xform, boxes: int) -> np.ndarray:
    """One image's (boxes, 5) truth from its (N, 5) [id, x, y, w, h]
    labels: shuffled (randomize_boxes, data.c:161-170), moved through the
    crop and flip (correct_boxes), slivers under 0.01 skipped (data.c:322),
    zero-padded, rows as [x, y, w, h, id]."""
    from .augment import correct_boxes
    truth = np.zeros((boxes, 5), np.float32)
    if len(labels):
        labels = labels.copy()
        rng.shuffle(labels)
        dx, dy, isx, isy, flip = box_xform
        labels = correct_boxes(labels, dx, dy, isx, isy, flip)
        kept = 0
        for row in labels[:boxes]:
            if row[3] < 0.01 or row[4] < 0.01:
                continue
            truth[kept] = [row[1], row[2], row[3], row[4], row[0]]
            kept += 1
    return truth


def stack_batch(aug: DeviceAugmenter, frames, params):
    """The zero-padded uint8 canvas of ``frames`` (HWC uint8 arrays) and
    the :meth:`DeviceAugmenter.columns` of ``params``."""
    hmax = max(im.shape[0] for im in frames)
    wmax = max(im.shape[1] for im in frames)
    canvas = np.zeros((len(frames), hmax, wmax, 3), np.uint8)
    for b, im in enumerate(frames):
        canvas[b, :im.shape[0], :im.shape[1]] = im
    return canvas, aug.columns(params)


__all__ = ["DeviceAugmenter", "augment_batch", "draw_params",
           "host_coeffs", "correct_truth", "stack_batch"]
