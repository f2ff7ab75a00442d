"""The PPM writer of the nightmare app (``_save_ppm``), which ``detect
-out`` and the streaming demo's ``-outdir`` use to save drawn frames.

Counterpart of ``sr_object_detection_tpu/apps/nightmare_app.py``; the
``nightmare`` command itself is not ported yet (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

import numpy as np


def _save_ppm(path: str, im: np.ndarray):
    with open(path, "wb") as f:
        h, w = im.shape[:2]
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write((np.clip(im, 0, 1) * 255).astype(np.uint8).tobytes())


__all__ = ["_save_ppm"]
