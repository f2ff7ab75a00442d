"""Image preprocessing with darknet-exact numerics.

Counterpart of ``sr_object_detection_tpu/ops/image.py``. The numpy halves
(``_resize_coeffs``, ``resize_image_np``, ``resize_min_np``,
``crop_image_np``, ``letterbox_image_np``, ``_load_pnm``,
``load_image_rgb``, ``load_image_u8``) are copied as they are; ``resize_image``
is the torch version the batch-1 engine runs on the device, with the tap
tables computed on the host in numpy so that its indices match the host
path exactly.

Layout: images are HWC float32 in [0,1], RGB.
"""

from __future__ import annotations

import numpy as np
import torch


def _resize_coeffs(in_size: int, out_size: int, *, clamp_last: bool):
    """Darknet source coordinates, float32 math: s = c * (in-1)/(out-1).

    The horizontal pass CLAMPS the last column (and in_size==1) to
    exactly input[-1] (image.c:1961-1963); the vertical pass instead
    just skips the second tap for the last row, keeping its (1-dy)
    weight on the first tap (image.c:1977-1988). ``clamp_last`` selects
    between the two behaviors. Returns (i0, i1, w0, w1).
    """
    if out_size > 1:
        scale = np.float32(in_size - 1) / np.float32(out_size - 1)
    else:
        scale = np.float32(0.0)
    s = np.arange(out_size, dtype=np.float32) * scale
    i0 = s.astype(np.int32)
    d = (s - i0).astype(np.float32)
    last = (np.arange(out_size) == out_size - 1) | (in_size == 1)
    if clamp_last:
        i0 = np.where(last, in_size - 1, i0)
        w0 = np.where(last, np.float32(1.0), 1.0 - d).astype(np.float32)
        w1 = np.where(last, np.float32(0.0), d).astype(np.float32)
    else:
        w0 = (1.0 - d).astype(np.float32)
        w1 = np.where(last, np.float32(0.0), d).astype(np.float32)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    return i0, i1, w0, w1


def resize_image_np(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Two-pass bilinear resize, HWC float32, darknet-exact
    (image.c:1950-1992: horizontal pass with last-column clamp, then
    vertical pass with last-row second-tap skip)."""
    im = im.astype(np.float32)
    iw = im.shape[1]
    ih = im.shape[0]
    x0, x1, wx0, wx1 = _resize_coeffs(iw, w, clamp_last=True)
    part = wx0[None, :, None] * im[:, x0, :] + wx1[None, :, None] * im[:, x1, :]
    y0, y1, wy0, wy1 = _resize_coeffs(ih, h, clamp_last=False)
    out = wy0[:, None, None] * part[y0, :, :] + wy1[:, None, None] * part[y1, :, :]
    return out.astype(np.float32)


def resize_image(im, w: int, h: int):
    """torch version of :func:`resize_image_np`; im: (..., H, W, C)
    float32 on any device."""
    ih, iw = im.shape[-3], im.shape[-2]
    dev = im.device

    def tables(in_size, out_size, clamp_last):
        i0, i1, w0, w1 = _resize_coeffs(in_size, out_size,
                                        clamp_last=clamp_last)
        return (torch.from_numpy(i0.astype(np.int64)).to(dev),
                torch.from_numpy(i1.astype(np.int64)).to(dev),
                torch.from_numpy(w0).to(dev), torch.from_numpy(w1).to(dev))

    x0, x1, wx0, wx1 = tables(iw, w, True)
    part = (wx0[:, None] * im.index_select(-2, x0)
            + wx1[:, None] * im.index_select(-2, x1))
    y0, y1, wy0, wy1 = tables(ih, h, False)
    return (wy0[:, None, None] * part.index_select(-3, y0)
            + wy1[:, None, None] * part.index_select(-3, y1))


def resize_min_np(im: np.ndarray, m: int) -> np.ndarray:
    """Short side -> m keeping aspect, integer scaling
    (image.c:1662-1676); returns the input when dims already match."""
    ih, iw = im.shape[:2]
    if iw < ih:
        w, h = m, (ih * m) // iw
    else:
        w, h = (iw * m) // ih, m
    if (w, h) == (iw, ih):
        return im.astype(np.float32)
    return resize_image_np(im, w, h)


def crop_image_np(im: np.ndarray, dx: int, dy: int, w: int, h: int
                  ) -> np.ndarray:
    """Fixed-size crop with edge-replication for out-of-bounds coords
    (image.c:1512-1532: constrain_int clamps source row/col)."""
    ih, iw = im.shape[:2]
    rows = np.clip(np.arange(h) + dy, 0, ih - 1)
    cols = np.clip(np.arange(w) + dx, 0, iw - 1)
    return im[rows[:, None], cols[None, :], :].astype(np.float32)


def letterbox_dims(iw: int, ih: int, w: int, h: int) -> tuple[int, int]:
    """Aspect-preserving inner size (image.c:1609-1617, int math)."""
    if (w / iw) < (h / ih):
        return w, (ih * w) // iw
    return (iw * h) // ih, h


def letterbox_image_np(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Resize preserving aspect, embed centered on a 0.5-gray canvas
    (image.c:1624-1644)."""
    ih, iw, c = im.shape
    nw, nh = letterbox_dims(iw, ih, w, h)
    resized = resize_image_np(im, nw, nh)
    out = np.full((h, w, c), 0.5, dtype=np.float32)
    dy, dx = (h - nh) // 2, (w - nw) // 2
    out[dy:dy + nh, dx:dx + nw, :] = resized
    return out


def load_image_rgb(path: str) -> np.ndarray:
    """Decode an image file to HWC float32 RGB in [0,1].

    The analog of load_image_color/load_image_stb (image.c:2045-2092,
    stb decode then /255). Uses PIL when available; falls back to a
    tiny PPM/PGM reader, so binary PNM works without PIL.
    """
    try:
        from PIL import Image  # type: ignore
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return arr
    except ImportError:
        return _load_pnm(path)


def load_image_u8(path: str) -> np.ndarray:
    """Decode to HWC uint8 RGB (no /255) — the device-augmentation
    canvas format (data/device_aug.py): the /255 happens on device so
    the host->device copy moves 1 byte/px."""
    try:
        from PIL import Image  # type: ignore
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.uint8)
    except ImportError:
        return (np.clip(_load_pnm(path), 0, 1) * 255 + 0.5).astype(
            np.uint8)


def _load_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError(f"cannot decode {path!r} without PIL (only PNM)")
    fields: list[bytes] = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    w, h, maxv = (int(x) for x in fields)
    ch = 3 if data[:2] == b"P6" else 1
    arr = np.frombuffer(data, dtype=np.uint8, count=w * h * ch, offset=pos)
    arr = arr.reshape(h, w, ch).astype(np.float32) / float(maxv)
    if ch == 1:
        arr = np.repeat(arr, 3, axis=2)
    return arr


__all__ = [
    "resize_image_np", "resize_image", "resize_min_np", "crop_image_np",
    "letterbox_image_np", "letterbox_dims", "load_image_rgb",
    "load_image_u8",
]
