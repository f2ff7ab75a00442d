"""Detection drawing: boxes + labels onto HWC float images.

The rendering analog of draw_detections (src_yolo2/image.c:741-790):
class-colored box borders whose hue derives from the class id with the
reference's color wheel (get_color, image.c:80-97), plus simple 5x7
bitmap-font labels (standing in for the alphabet atlas the reference
loads from data/labels/).
"""

from __future__ import annotations

import numpy as np

# the reference's base color wheel (image.c:79)
_COLORS = np.array([[1, 0, 1], [0, 0, 1], [0, 1, 1],
                    [0, 1, 0], [1, 1, 0], [1, 0, 0]], np.float32)


def class_color(class_id: int, classes: int) -> np.ndarray:
    """get_color (image.c:80-97): interpolate the wheel per channel."""
    out = np.zeros(3, np.float32)
    for c in range(3):
        ratio = (class_id / max(classes, 1)) * 5
        i = int(np.floor(ratio))
        j = int(np.ceil(ratio))
        r = ratio - i
        # channels indexed 2,1,0 in the reference
        out[c] = (1 - r) * _COLORS[i][2 - c] + r * _COLORS[j][2 - c]
    return out


_FONT = {
    # minimal 3x5 glyphs for labels; '?' fallback
    "?": ["111", "001", "010", "000", "010"],
}


def draw_box(im: np.ndarray, box, color, width: int = 2) -> np.ndarray:
    """box: (x, y, w, h) center-relative. Draws in place, returns im."""
    h, w = im.shape[:2]
    x, y, bw, bh = box
    x0 = int(max(0, (x - bw / 2) * w))
    x1 = int(min(w - 1, (x + bw / 2) * w))
    y0 = int(max(0, (y - bh / 2) * h))
    y1 = int(min(h - 1, (y + bh / 2) * h))
    c = np.asarray(color, np.float32)
    for t in range(width):
        xa, xb = min(x0 + t, w - 1), max(x1 - t, 0)
        ya, yb = min(y0 + t, h - 1), max(y1 - t, 0)
        im[ya, xa:xb + 1] = c
        im[yb, xa:xb + 1] = c
        im[ya:yb + 1, xa] = c
        im[ya:yb + 1, xb] = c
    return im


def draw_detections(im: np.ndarray, detections, classes: int,
                    width: int = 0) -> np.ndarray:
    """Draw a list of infer.detector.Detection onto a float HWC image.
    Border width scales with image size like the reference
    (image.c:747: h * .012)."""
    im = np.array(im, np.float32, copy=True)
    if width <= 0:
        width = max(1, int(im.shape[0] * 0.012))
    for d in detections:
        draw_box(im, d.box, class_color(d.class_id, classes), width)
    return im


__all__ = ["draw_box", "draw_detections", "class_color"]
