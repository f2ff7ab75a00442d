"""Vectorized image augmentation with reference-equivalent semantics.

numpy re-implementations of the reference's augmentation ops
(src_yolo2/image.c): crop_image (edge-clamped), flip, HSV distort
(rgb_to_hsv:1718 / distort_image:1903 piecewise math, single-wrap hue
shift, final [0,1] clamp). RNG *semantics* (uniform ranges, rand_scale's
reciprocal coin-flip) match the reference; streams of course differ.
"""

from __future__ import annotations

import numpy as np


def crop_image(im: np.ndarray, dx: int, dy: int, w: int, h: int
               ) -> np.ndarray:
    """Edge-clamped crop (image.c:1512-1535 reads clamped src pixels).
    Fully in-bounds crops (the common jitter case) take a view-copy
    slice; only border-crossing crops pay the clamped gather."""
    ih, iw, c = im.shape
    if 0 <= dy and dy + h <= ih and 0 <= dx and dx + w <= iw:
        return im[dy:dy + h, dx:dx + w].copy()
    ys = np.clip(np.arange(dy, dy + h), 0, ih - 1)
    xs = np.clip(np.arange(dx, dx + w), 0, iw - 1)
    return im[np.ix_(ys, xs)].copy()


def flip_horizontal(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1, :].copy()


def rgb_to_hsv(im: np.ndarray) -> np.ndarray:
    """Vectorized image.c:1718-1753 (h in [0,1), s, v)."""
    r, g, b = im[..., 0], im[..., 1], im[..., 2]
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    delta = mx - mn
    v = mx
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(mx == 0, 0.0, delta / np.where(mx == 0, 1.0, mx))
        dsafe = np.where(delta == 0, 1.0, delta)
        h = np.where(
            r == mx, (g - b) / dsafe,
            np.where(g == mx, 2.0 + (b - r) / dsafe,
                     4.0 + (r - g) / dsafe))
    h = np.where(delta == 0, 0.0, h)
    h = np.where(h < 0, h + 6.0, h) / 6.0
    h = np.where(mx == 0, 0.0, h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(im: np.ndarray) -> np.ndarray:
    """Vectorized image.c:1755-1795."""
    h = im[..., 0] * 6.0
    s = im[..., 1]
    v = im[..., 2]
    idx = np.floor(h).astype(np.int32)
    f = h - idx
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    idx = (idx % 6)[None]
    # same sextant table as image.c:1767-1793; np.choose computes the
    # identical gather but is ~6x slower (per-candidate broadcasting)
    r = np.take_along_axis(np.stack([v, q, p, p, t, v]), idx, 0)[0]
    g = np.take_along_axis(np.stack([t, v, v, q, p, p]), idx, 0)[0]
    b = np.take_along_axis(np.stack([p, p, t, v, v, q]), idx, 0)[0]
    gray = s == 0
    r = np.where(gray, v, r)
    g = np.where(gray, v, g)
    b = np.where(gray, v, b)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def distort_image(im: np.ndarray, hue: float, sat: float, val: float
                  ) -> np.ndarray:
    """distort_image (image.c:1903-1916): scale S and V, shift H with
    single wrap, convert back, clamp [0,1]."""
    hsv = rgb_to_hsv(im)
    hsv[..., 1] *= sat
    hsv[..., 2] *= val
    h = hsv[..., 0] + hue
    h = np.where(h > 1.0, h - 1.0, h)
    h = np.where(h < 0.0, h + 1.0, h)
    hsv[..., 0] = h
    return np.clip(hsv_to_rgb(hsv), 0.0, 1.0)


def rand_scale(rng: np.random.Generator, s: float) -> float:
    """utils.c rand_scale: uniform in [1, s], reciprocal half the time."""
    scale = rng.uniform(1.0, s) if s > 1 else 1.0
    if rng.integers(0, 2) == 1:
        return 1.0 / scale
    return scale


def random_distort_image(im: np.ndarray, rng: np.random.Generator,
                         hue: float, saturation: float, exposure: float
                         ) -> np.ndarray:
    dhue = rng.uniform(-hue, hue)
    dsat = rand_scale(rng, saturation)
    dexp = rand_scale(rng, exposure)
    if dhue == 0 and dsat == 1 and dexp == 1:
        return im
    return distort_image(im, dhue, dsat, dexp)


def correct_boxes(boxes: np.ndarray, dx: float, dy: float,
                  sx: float, sy: float, flip: bool) -> np.ndarray:
    """data.c:172-207: remap labels through the crop/flip transform.

    boxes: (N, 5) [id, x, y, w, h] relative. Returns same layout.
    The (0,0)-centered sentinel becomes 999999 (the reference uses this
    to signal classification-only truths in the 9k pipeline).
    """
    out = boxes.copy()
    if len(out) == 0:
        return out
    sentinel = (out[:, 1] == 0) & (out[:, 2] == 0)
    x, y, w, h = out[:, 1], out[:, 2], out[:, 3], out[:, 4]
    left = (x - w / 2) * sx - dx
    right = (x + w / 2) * sx - dx
    top = (y - h / 2) * sy - dy
    bottom = (y + h / 2) * sy - dy
    if flip:
        left, right = 1.0 - right, 1.0 - left
    left = np.clip(left, 0, 1)
    right = np.clip(right, 0, 1)
    top = np.clip(top, 0, 1)
    bottom = np.clip(bottom, 0, 1)
    out[:, 1] = (left + right) / 2
    out[:, 2] = (top + bottom) / 2
    out[:, 3] = np.clip(right - left, 0, 1)
    out[:, 4] = np.clip(bottom - top, 0, 1)
    out[sentinel, 1:] = 999999.0
    return out


__all__ = ["crop_image", "flip_horizontal", "rgb_to_hsv", "hsv_to_rgb",
           "distort_image", "random_distort_image", "rand_scale",
           "correct_boxes"]
